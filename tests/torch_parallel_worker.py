"""One rank of a gloo world on the CPU, for
tests/test_torch_parallel_multiprocess.py:

    python tests/torch_parallel_worker.py <dir> <rank> <world size>

Joins the world through a file store in <dir>, reads the inputs the test
wrote there (`inputs.npz`), runs every check of `waverange_tpu_torch.
parallel` on them and writes what this rank got to `out_<rank>.npz`. The
test compares the ranks' outputs with one another, with one device and
with the JAX package."""
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waverange_tpu_torch.parallel import distributed as PD  # noqa: E402
from waverange_tpu_torch.parallel import mesh as PM  # noqa: E402

TOL = 1e-6


def main(workdir: str, rank: int, size: int) -> None:
    torch.set_num_threads(1)
    PD.init_distributed(init_method=f"file://{workdir}/store",
                        world_size=size, rank=rank, device="cpu")
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}

    # ordered gather: this rank holds ids rank, rank + size, ...
    ids = list(range(rank, 7, size))
    got = PD.gather_streams_ordered([bytes([i]) * (3 * i) for i in ids],
                                    ids)
    out["gather"] = np.frombuffer(b"".join(got), np.uint8)
    out["gather_n"] = np.array(len(got))

    group = PM.make_group()
    batch = inp["batch"]
    encs = PM.encode_fields_sharded(batch, TOL, group=group,
                                    backend_threads=2, device="cpu")
    out["enc_peak"] = np.array(PM._last_peak_resident)
    out["sharded"] = np.frombuffer(b"".join(
        PM._pack(e) for e in encs), np.uint8)
    out["sharded_n"] = np.array(len(encs))
    out["sharded_dec"] = PM.decode_fields_sharded(encs, group=group,
                                                  backend_threads=2,
                                                  device="cpu")
    out["dec_peak"] = np.array(PM._last_peak_resident_decode)

    divided = PM.encode_field_divided(inp["divided"], TOL, group=group,
                                      device="cpu")
    out["divided"] = np.frombuffer(b"".join(
        PM._pack(e) for e in divided), np.uint8)
    out["divided_dec"] = PM.decode_field_divided(divided, group=group,
                                                 device="cpu")

    ushape = inp["united"].shape
    nzl = ushape[0] // size
    slab = torch.from_numpy(inp["united"][rank * nzl:(rank + 1) * nzl])
    planes, deps, minv, nlay, tolabs, *_ = PM.united_encode_step(
        group, ushape)(slab, TOL)
    out["united"] = planes[:int(nlay)].numpy()
    out["united_tolabs"] = tolabs.numpy()

    for name in ("dist_a", "dist_deep", "dist_fallback"):
        fld = inp[name]
        shape = fld.shape
        nzl = shape[0] // size
        slab = torch.from_numpy(fld[rank * nzl:(rank + 1) * nzl])
        planes, deps, minv, nlay, tolabs, *_ = PM.distributed_encode_step(
            group, shape)(slab, TOL)
        nl = int(nlay)
        out[name] = planes[:nl].numpy()
        out[name + "_deps"] = deps[:nl].numpy()
        out[name + "_minv"] = minv[:nl].numpy()
        out[name + "_dec"] = PM.distributed_decode_step(group, shape)(
            planes[:nl].contiguous(), deps[:nl], minv[:nl]).numpy()
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()
    print("WORKER_OK", rank)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
