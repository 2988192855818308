"""Launchers and cost models (counterpart of ``repro/launch``): ``python
-m repro_torch.launch.train`` (the LM launcher), ``python -m
repro_torch.launch.dryrun`` (the count of work of every arch x shape cell
on ``meta``), ``analytic`` (the reference's HBM-traffic and FLOP model),
``roofline`` (the H100's peaks, ``RooflineTerms``, the count of a
program's FLOPs whatever implements it) and ``mesh`` (mesh builders)."""
