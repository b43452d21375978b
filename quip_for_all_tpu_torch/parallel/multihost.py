"""Multi-host (multi-process) entry: joining the process group and the
DCN x ICI hybrid mesh — counterpart of
``quip_for_all_tpu/parallel/multihost.py``.

Every host runs the same program, one process a rank. ``initialize``
joins the default ``torch.distributed`` process group (gloo, the backend
``parallel/comm.py`` is written for: it takes CPU and CUDA tensors and
lets ranks share a card), and ``make_hybrid_mesh`` lays the ranks out as
``parallel/sharding.py``'s ("dp", ["ep",] "tp") mesh with the hosts on the
outer "dp" axis, so that

  * the "dp" (replica) axis crosses hosts: nothing a token needs runs
    over it;
  * the "tp" (and "ep") axes stay within a host, where every token's
    collectives run.

``shard_params`` and ``ServingEngine(mesh=)`` take the hybrid mesh as they
take ``make_mesh``'s.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch.distributed as dist

from .sharding import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Join the default process group; returns this process' rank.

    The arguments fall back to the environment variables torchrun sets:
    ``MASTER_ADDR:MASTER_PORT`` for the coordinator (``host:port``),
    ``WORLD_SIZE`` and ``RANK``. With none of them set it is a no-op that
    returns 0 (one process, as the JAX package's returns
    ``process_index()``); in a joined process it returns the rank. The
    group runs gloo. A join that is configured but incomplete, or fails,
    raises."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return 0
    missing = [name for name, v in (("coordinator_address",
                                     coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id))
               if v is None]
    if missing:
        raise ValueError(f"initialize: {', '.join(missing)} not given and "
                         "not in the environment (MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def free_port() -> int:
    """A free TCP port on the loopback interface, for a coordinator
    address of ranks that this process spawns on its own host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_keys() -> list:
    """Each rank's host, in rank order (a collective: every rank calls
    it): torchrun's ``GROUP_RANK`` (the node's index) where every rank has
    it, else the host names, numbered in the order of their first rank."""
    from . import comm
    mine = os.environ.get("GROUP_RANK")
    keys = comm.gather_objects(
        int(mine) if mine is not None else socket.gethostname())
    if all(isinstance(k, int) for k in keys):
        return keys
    names = [str(k) for k in keys]
    first = {}
    for name in names:
        first.setdefault(name, len(first))
    return [first[name] for name in names]


def make_hybrid_mesh(dcn_dp: Optional[int] = None,
                     ici_tp: Optional[int] = None,
                     ici_ep: int = 1) -> Mesh:
    """The ("dp", ["ep",] "tp") mesh with "dp" across hosts and "ep",
    "tp" within one: the ranks ordered by (host, global rank), as the JAX
    package's fallback sorts devices by (process_index, id), laid out
    row-major (``parallel/sharding.py`` ``make_mesh(order=)``). ``dcn_dp``
    defaults to the number of hosts, ``ici_tp`` to the rest of the
    world."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs an initialised process "
                           "group (initialize)")
    world = dist.get_world_size()
    keys = host_keys()
    if dcn_dp is None:
        dcn_dp = len(set(keys))
    if ici_tp is None:
        ici_tp = world // (dcn_dp * ici_ep)
    if dcn_dp * ici_ep * ici_tp != world:
        raise ValueError(f"dcn_dp {dcn_dp} x ici_ep {ici_ep} x ici_tp "
                         f"{ici_tp} != world size {world}")
    order = sorted(range(world), key=lambda g: (keys[g], g))
    return make_mesh(dp=dcn_dp, tp=ici_tp, ep=ici_ep, order=order)


def mesh_topology(mesh: Mesh) -> str:
    """'dcn x ici' label of a hybrid mesh, the JAX package's string for
    the same shape, e.g. ``dcn[dp=2] x ici[ep=2 x tp=2]``."""
    shape = dict(mesh.shape)
    dcn = shape.get("dp", 1)
    ici = " x ".join(f"{k}={v}" for k, v in shape.items() if k != "dp")
    return f"dcn[dp={dcn}] x ici[{ici}]"
