"""One rank of the port's compressed gradient reduce over ``torch.distributed``
(gloo, CPU), started by ``tests/test_torch_collectives.py`` through
``torch.multiprocessing.spawn``.  Imports only torch, numpy and the port, so
a spawned child starts quickly and never loads JAX."""
import numpy as np
import torch
import torch.distributed as dist


def run_rank(rank, world, init_file, in_npz, out_npz, kind, widths, fused):
    from repro_torch.dist import ProcessGroupMesh, ef_wire_pmean
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        with np.load(in_npz) as data:
            tree = {k: torch.from_numpy(data[k][rank:rank + 1].copy())
                    for k in data.files}
        d, r = ef_wire_pmean(tree, ProcessGroupMesh(), kind, widths=widths,
                             fused=fused)
        np.savez(out_npz.format(rank=rank),
                 **{f"d/{k}": v.numpy() for k, v in d.items()},
                 **{f"r/{k}": v.numpy() for k, v in r.items()})
    finally:
        dist.destroy_process_group()
