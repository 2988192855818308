"""Launchers (counterpart of ``repro/launch``): ``python -m
repro_torch.launch.train``.  The reference's TPU pod tools (``mesh``,
``dryrun``, ``analytic``, ``roofline``) are not ported."""
