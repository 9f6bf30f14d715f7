"""Which torch.distributed collectives the `gloo` backend runs on CUDA
tensors, and whether NCCL starts at world size 1.

Run from the repository root on a machine with one card:

    python3 chip_diag/collectives.py

It spawns two `gloo` ranks that share cuda:0 and tries, on CUDA tensors,
each collective the port's parallel layer calls (all_reduce, broadcast,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single,
batch_isend_irecv) and FSDP2's fully_shard over a small module; then one
`nccl` rank. Lines to read start with DIAG: the op, ok or the error's first
line, and whether the result was right.
"""

import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(rank, name, fn):
    try:
        ok = fn()
        msg = "ok" if ok else "WRONG"
    except Exception as exc:  # report and go on
        msg = "error: " + (str(exc).strip().splitlines() or [repr(exc)])[0]
    if rank == 0:
        print("DIAG gloo-cuda %s %s" % (name, msg[:300]), flush=True)


def _gloo(rank, world, path):
    dist.init_process_group("gloo", init_method="file://" + path, rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == 3).all())

    def broadcast():
        t = torch.full((4,), float(rank), device=dev)
        dist.broadcast(t, src=1)
        return bool((t == 1).all())

    def all_gather():
        t = torch.full((2,), float(rank), device=dev)
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, t)
        return out.tolist() == [0, 0, 1, 1]

    def reduce_scatter():
        t = torch.arange(4, device=dev, dtype=torch.float32)
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, t)
        return out.tolist() == [2.0 * (2 * rank), 2.0 * (2 * rank + 1)]

    def all_to_all():
        t = torch.tensor([10.0 * rank, 10.0 * rank + 1], device=dev)
        out = torch.empty(2, device=dev)
        dist.all_to_all_single(out, t)
        return out.tolist() == [float(rank), 10.0 + rank]

    def p2p():
        send = torch.full((3,), float(rank), device=dev)
        recv = torch.empty(3, device=dev)
        ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return bool((recv == (rank - 1) % world).all())

    def fsdp():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("fsdp",))
        torch.manual_seed(0)
        m = torch.nn.Linear(8, 4).to(dev)
        fully_shard(m, mesh=mesh)
        m(torch.ones(2, 8, device=dev)).sum().backward()
        g = m.weight.grad.full_tensor()
        return bool(torch.isfinite(g).all())

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_to_all_single", all_to_all),
                     ("batch_isend_irecv", p2p), ("fully_shard", fsdp)):
        _try(rank, name, fn)
        dist.barrier()
    dist.destroy_process_group()


def main():
    print("DIAG torch %s cuda %s python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]),
        flush=True)
    if not torch.cuda.is_available():
        print("DIAG no card")
        return 1
    path = tempfile.mktemp(prefix="gloo-rdzv-")
    try:
        mp.spawn(_gloo, args=(2, path), nprocs=2, join=True)
    except Exception:
        traceback.print_exc()
        print("DIAG gloo spawn failed")
    path = tempfile.mktemp(prefix="nccl-rdzv-")
    try:
        dist.init_process_group("nccl", init_method="file://" + path,
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        print("DIAG nccl world 1 all_reduce %s" % ("ok" if bool(
            (t == 1).all()) else "WRONG"))
        dist.destroy_process_group()
    except Exception as exc:
        print("DIAG nccl world 1 error: %s" % str(exc).splitlines()[0])
    return 0


if __name__ == "__main__":
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    sys.exit(main())
