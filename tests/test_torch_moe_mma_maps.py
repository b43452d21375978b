"""The unit walk and row map of K4/K5's tensor-core body on the CPU, before
the card runs it.

K4/K5 (csrc/moe_decode_matmul.cu) runs K1's body, csrc/nibble_mma_small.cuh,
with the codes policy MoeCodes and the body's row map: every block counts
the rows of each expert id from eids, lists the experts present in
ascending order, and cuts each expert's rows into chunks of ROWS = 8 rows
(one n8 tile of rows, whatever the bound on one expert's rows says). The
units of work, (expert present, chunk, channel tile) in that order, are
dealt to the G blocks of the grid in runs: block b takes units
[b*U/G, (b+1)*U/G). At each new chunk a warp lists the
chunk's rows in row order by ballots (ordinals c*ROWS .. c*ROWS + ROWS - 1
of the expert's rows) into the row map; block row r reads x[rows[r]] and
the tile of out[rows[r], :] is written from K1's arithmetic on the unit's
expert's planes.

This file emulates that walk in torch (the table, the runs, the gather
and the scattered store, with K1's slab arithmetic from
test_torch_small_m_maps.py) and holds the result to the plain twin
``moe_fused_matmul_ref`` at Mixtral-8x7B's w2 depth (Gp = 1792) with a
narrow q_out, at R = 2, 16 and 62 top-2 rows, one expert with 40 rows, and
64 experts, at the kernels' tolerance (1e-5 of the max, plus one bf16 ulp
for bf16 outputs); every output element is written exactly once. A walk
that drops an expert's 33rd row (the first of its fifth chunk) must miss.
One case goes on to the JAX package's Pallas MoE kernel
(``moe_pallas.moe_fused_matmul``, interpret mode) on the same numpy
inputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.ops import moe_pallas as jmp

from quip_for_all_tpu_torch.ops import moe_matmul as mm
from quip_for_all_tpu_torch.ops.qtensor import decode_affine

from test_torch_small_m_maps import AFFINE, close, emulate

pytestmark = pytest.mark.fast

MAX_EXPERTS = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS = 8                       # one n8 tile of rows a block (launch_nt)


def walk(eids, E, ntiles, G, drop=False):
    """The units each of G blocks computes, in its order, and the row map
    of each: [(block, expert, rows, tile)]. ``drop`` never lists an
    expert's 33rd row (ordinal 32; a negative control)."""
    ids = eids.tolist()
    cnt = [0] * MAX_EXPERTS
    for e in ids:
        if 0 <= e < E:
            cnt[e] += 1
    ex = [e for e in range(MAX_EXPERTS) if cnt[e] > 0]   # ascending
    nck = [-(-cnt[e] // ROWS) for e in ex]
    U = sum(nck) * ntiles
    units = []
    for b in range(G):
        ub, ue = U * b // G, U * (b + 1) // G
        if ue == ub:
            continue                            # the block leaves
        # start: the unit ub as (j, c, tile), then counters
        u, j = ub, 0
        while u >= nck[j] * ntiles:
            u -= nck[j] * ntiles
            j += 1
        c, tile = divmod(u, ntiles)
        rows = None
        for k in range(ue - ub):
            if k == 0 or tile == 0:             # a new chunk: its row map
                lo = c * ROWS
                rows, o = [], 0
                for r, e in enumerate(ids):
                    if e != ex[j]:
                        continue
                    if lo <= o < lo + ROWS and not (drop and o == 32):
                        rows.append(r)
                    o += 1
            units.append((b, ex[j], tuple(rows), tile))
            tile += 1
            if tile == ntiles:
                tile, c = 0, c + 1
                if c == nck[j]:
                    c, j = 0, j + 1
    return units


def emulate_moe(x_perm, eids, planes, affine, G, BN=32, drop=False):
    """The output of the walk: each unit's tile of K1's arithmetic on its
    expert's planes and its chunk's rows, stored at the row map's rows (NaN
    where nothing is written), and how often each element was written."""
    R = x_perm.shape[0]
    E, q_out, _ = planes[0].shape
    ntiles = -(-q_out // BN)
    out = torch.full((R, q_out), float("nan"), dtype=x_perm.dtype)
    writes = torch.zeros((R, q_out), dtype=torch.int64)
    done = {}
    for _, e, rows, tile in walk(eids, E, ntiles, G, drop):
        if (e, rows) not in done:               # a chunk's rows, all tiles
            done[(e, rows)] = emulate(x_perm[list(rows)],
                                      [p[e] for p in planes], affine, None,
                                      1)
        n0, n1 = tile * BN, min(q_out, tile * BN + BN)
        out[list(rows), n0:n1] = done[(e, rows)][:, n0:n1]
        writes[list(rows), n0:n1] += 1
    return out, writes


def top2(tokens, E, rng):
    return np.stack([rng.permutation(E)[:2]
                     for _ in range(tokens)]).reshape(-1)


def make(E, q_out, Gp, eids, n_sets, dtype, seed):
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.integers(0, 1 << 32, (E, q_out, Gp),
                                            dtype=np.uint64)
                               .astype(np.uint32).view(np.int32))
              for _ in range(n_sets)]
    x = torch.from_numpy(rng.standard_normal((len(eids), 8 * Gp))
                         .astype(np.float32)).to(dtype)
    eids = torch.from_numpy(np.asarray(eids, dtype=np.int32))
    affine = AFFINE[n_sets]
    return x, eids, planes, affine, mm.moe_fused_matmul_ref(
        x, eids, planes, affine)


def _eids(case, rng):
    """(E, R's ids) of a case."""
    if case.startswith("top2_"):
        return 8, top2(int(case[5:]), 8, rng)
    if case == "one_expert_40":
        return 8, np.full(40, 3)
    return 64, rng.permutation(64)                         # 64 experts


@pytest.mark.parametrize("G", [5, 264])
@pytest.mark.parametrize("dtype,n_sets", [(torch.bfloat16, 1),
                                          (torch.float32, 2)])
@pytest.mark.parametrize("case", ["top2_1", "top2_8", "top2_31",
                                  "one_expert_40", "e64"])
def test_moe_walk_matches_the_twin(case, dtype, n_sets, G):
    rng = np.random.default_rng(len(case) + n_sets)
    E, eids = _eids(case, rng)
    Gp = 1792 if case != "e64" else 128
    x, eids, planes, affine, want = make(E, 16, Gp, eids, n_sets, dtype,
                                         seed=G)
    got, writes = emulate_moe(x, eids, planes, affine, G, BN=8)
    assert torch.equal(writes, torch.ones_like(writes))
    assert got.dtype == want.dtype and close(got, want, dtype)


def test_a_walk_that_drops_the_33rd_row_misses():
    """Negative control: one expert's 40 rows, the 33rd never listed."""
    x, eids, planes, affine, want = make(8, 16, 256, np.full(40, 3), 1,
                                         torch.float32, seed=0)
    got, writes = emulate_moe(x, eids, planes, affine, 5, BN=8)
    assert close(got, want, torch.float32)
    got, writes = emulate_moe(x, eids, planes, affine, 5, BN=8, drop=True)
    assert int(writes[32].sum()) == 0
    assert not close(got, want, torch.float32)


@pytest.mark.parametrize("G", [1, 3, 132, 264, 5000])
@pytest.mark.parametrize("R", [2, 16, 62, 600])
def test_every_unit_is_taken_once(R, G):
    """The runs of G blocks take every (expert, chunk, tile) unit once, and
    the rows of an expert's chunks are its rows in row order."""
    rng = np.random.default_rng(R)
    eids = torch.from_numpy(rng.integers(0, 8, R).astype(np.int32))
    ntiles = 7
    units = walk(eids, 8, ntiles, G)
    keys = [(e, rows, tile) for _, e, rows, tile in units]
    assert len(keys) == len(set(keys))
    for e in range(8):
        mine = [r for r in range(R) if int(eids[r]) == e]
        chunks = sorted({rows for e2, rows, _ in keys if e2 == e})
        assert [r for c in chunks for r in c] == mine
        assert all(len(c) <= ROWS for c in chunks)
        for c in chunks:
            assert sorted(t for e2, rows, t in keys
                          if e2 == e and rows == c) == list(range(ntiles))


def test_moe_walk_matches_the_jax_pallas_kernel():
    """The same numpy planes, ids and x through the JAX package's Pallas
    MoE kernel (interpret mode on the CPU) and through the emulated walk:
    5 top-2 rows of 16 experts with repeats, 2 plane sets, f32."""
    E, q_out, Gp, R = 16, 256, 128, 5
    rng = np.random.default_rng(11)
    planes = {f"w{i}": rng.integers(0, 1 << 32, (E, q_out, Gp),
                                    dtype=np.uint64)
              .astype(np.uint32).view(np.int32) for i in range(2)}
    eids = np.array([2, 7, 2, 9, 7], dtype=np.int32)
    x = rng.standard_normal((R, 8, Gp)).astype(np.float32)
    x[:, :, 48:] = 0.0                           # zero pad lanes (q_in 384)
    x = x.reshape(R, 8 * Gp)
    rs = 1 / 3.45
    jmp._moe_call.clear_cache()
    want = np.asarray(jmp.moe_fused_matmul(
        jnp.asarray(x), jnp.asarray(eids),
        {k: jnp.asarray(v) for k, v in planes.items()}, "E8P12RVQ4B", rs,
        q_out).astype(jnp.float32))
    jmp._moe_call.clear_cache()
    got, writes = emulate_moe(
        torch.from_numpy(x), torch.from_numpy(eids),
        [torch.from_numpy(planes[k]) for k in sorted(planes)],
        decode_affine("E8P12RVQ4B", rs), 132)
    assert torch.equal(writes, torch.ones_like(writes))
    assert close(got, torch.from_numpy(want.copy()), torch.float32)
