"""The f32 attention kernels' design on the CPU (``csrc/attn_f32.cuh`` and the
f32 kernels of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``).

The kernels run only on a card (``tests/test_torch_cuda_kernels.py``). What
surrounds them is plain index arithmetic and f32 arithmetic in a fixed order,
and that is checked here:

* the launch plan (:func:`f32_plan`) at every attention shape of the 32-, 64-
  and 128-px UNets, from a spy on the UNet on the meta device: a plan the
  kernels take, its shared memory within a block's, and above 48 KB marked
  for the raised limit; the tile table is the one written in the sources;
* a numpy simulation of the thread-to-micro-tile map: in each pass every
  (query, key) pair is formed exactly once, every output element is written
  exactly once and nothing past S is stored, at ragged S;
* a numpy emulation of the forward's tiled online softmax in the kernel's
  key-tile order against :func:`attention_reference` (and the JAX package's
  Pallas forward in interpret mode) within the card's f32 limits.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.ops.flash_attention import _flash_fwd
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

# The card's limits (chip_smoke.py: REL_TOL[f32], M_ATOL, SUM_RTOL).
REL_TOL, M_ATOL, SUM_RTOL = 2e-5, 1e-5, 1e-4
INT_MAX = 2**31 - 1
H100_SMS = 132  # an H100 SXM's SMs: the card the plans here are pinned for

# The runs whose attention shapes the plan must take: (image, base width,
# batch or n), the four train steps of chip_smoke.py and the two sampling
# batches at 32 px, and the 128-px sampler.
RUNS = {"train32_b256": (32, 32, 256), "sample32_n16": (32, 32, 16),
        "sample32_cfg_n32": (32, 32, 32), "train64_b32": (64, 64, 32),
        "train128_w128_b4": (128, 128, 4), "train128_w32_b8": (128, 32, 8)}


def _attention_shapes(px, width, batch):
    """{(bh, s, d)} of the six attention calls of one Config-D forward: a spy
    on the blocks' ``flash_mha`` over the model on the meta device."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import cli
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import blocks, unet

    config = cli.config_from_args(cli.build_parser().parse_args(
        ["sample", "--variant", "3", "--image-size", str(px), "--image-channels", "3",
         "--compute-dtype", "float32", "--f-kernel", "3", "--f-beta", "2"]))
    config = dataclasses.replace(config, base_width=width, batch_size=batch)
    model = unet.build_model(config, device="meta")
    shapes = []

    def spy(q, k, v, scale):
        b, h, s, d = q.shape
        shapes.append((b * h, s, d))
        return torch.empty_like(q)

    real = blocks.flash_mha
    blocks.flash_mha = spy
    try:
        with torch.no_grad():
            model(torch.zeros((batch, px, px, 3), device="meta"),
                  torch.ones((batch,), dtype=torch.long, device="meta"))
    finally:
        blocks.flash_mha = real
    return shapes


def _kernel_takes(plan, bh, s, d):
    """The checks of the launches in csrc/ (launch_f32_heads, launch_f32)."""
    if plan.kernel == "fwd":
        if plan.heads not in (1, 2, 4) or (d == 128 and plan.heads != 1):
            return False
        if plan.heads > 1 and s > plan.rows // plan.heads:
            return False
    elif plan.heads != 1:
        return False
    return plan.blocks <= INT_MAX


@pytest.mark.parametrize("run", list(RUNS))
def test_plan_at_every_main_path_shape(run):
    shapes = _attention_shapes(*RUNS[run])
    assert len(shapes) == 6
    for bh, s, d in shapes:
        for kernel in fa.F32_KERNELS:
            plan = fa.f32_plan(kernel, bh, s, d, H100_SMS)
            assert _kernel_takes(plan, bh, s, d), (run, kernel, bh, s, d, plan)
            assert plan.smem_bytes <= fa.SMEM_MAX, (run, kernel, plan)
            assert plan.raised_smem == (plan.smem_bytes > fa.SMEM_DEFAULT), plan
            if kernel == "fwd":
                assert plan.layout == ("staged" if d >= 32 else "lane_sums")
            else:
                assert plan.layout == ("rows" if d <= 16 or d == 32 and s <= 32 else "staged")
            # every row of every head has a block, and no block stands past them all
            assert plan.row_tiles * plan.rows // plan.heads >= s
            assert plan.blocks == -(-bh // plan.heads) * plan.row_tiles


def test_tile_table_is_the_one_in_the_sources():
    tables = {("fwd", "FwdTile"): fa.F32_TILES["fwd"],
              ("fwd", "FwdSmallTile"): fa.F32_FWD_SMALL_TILES,
              ("bwd", "DqTile"): fa.F32_TILES["bwd_dq"],
              ("bwd", "DkvTile"): fa.F32_TILES["bwd_dkv"]}
    for (source, struct), table in tables.items():
        src = (kernels.CSRC / kernels.SOURCES[f"flash_{source}"]).read_text()
        found = {int(d): (int(ri), int(cj)) for d, ri, cj in re.findall(
            struct + r"<(\d+)> \{ static constexpr int kRI = (\d+), kCJ = (\d+); \}", src)}
        assert found == table, struct
    src = (kernels.CSRC / kernels.SOURCES["flash_fwd"]).read_text()
    # the small grid is a number of blocks an SM, times the card's SM count from the launch
    per_sm = re.search(r"constexpr long long kSmallGridPerSm = (\d+);", src)
    assert per_sm and int(per_sm.group(1)) == fa.F32_SMALL_GRID_PER_SM == 4
    assert "<= kSmallGridPerSm * sms)" in src
    src = (kernels.CSRC / kernels.SOURCES["flash_bwd"]).read_text()
    rows = {name: int(n) for name, n in re.findall(r"constexpr int (kRow\w+) = (\d+);", src)}
    assert rows == {"kRowThreads": fa.F32_ROWS["threads"], "kRowTile": fa.F32_ROWS["tile"]}
    assert "if (D <= 16 || s <= kRowTile)" in src and max(fa.F32_ROWS["depths"]) == 16
    assert fa.F32_ROWS["short_depth"] == 32 and "if constexpr (D <= 32)" in src
    # the shared header is hashed into every library's name (utils/kernels.py)
    assert (kernels.CSRC / "attn_f32.cuh").exists()


@pytest.mark.parametrize("kernel", fa.F32_KERNELS)
def test_plan_shared_memory_and_heads(kernel):
    smem = {d: fa.f32_plan(kernel, 64, 1024, d, H100_SMS).smem_bytes for d in fa.HEAD_DIMS}
    assert all(b <= fa.SMEM_MAX for b in smem.values())
    # f32 rows, padded to D + 4 floats, are whole 16-byte cp.async chunks
    assert all((d + 4) * 4 % fa.ALIGN == 0 for d in fa.HEAD_DIMS)
    heads = {s: fa.f32_plan(kernel, 64, s, 32, H100_SMS).heads for s in (16, 32, 64)}
    assert heads == ({16: 4, 32: 2, 64: 1} if kernel == "fwd" else {16: 1, 32: 1, 64: 1})
    # where it is 64 rows, the forward's tile takes the bf16 plan's heads
    for s in (16, 32, 64, 200):
        plan = fa.f32_plan(kernel, 1024, s, 32, H100_SMS)
        if kernel == "fwd":
            assert plan.heads == fa.fwd_plan(1024, s, 32).heads_per_block
    assert fa.f32_plan(kernel, 64, 16, 128, H100_SMS).heads == 1
    with pytest.raises(ValueError):
        fa.f32_plan(kernel, 64, 16, 4, H100_SMS)
    with pytest.raises(ValueError):
        fa.f32_plan("bwd", 64, 16, 8, H100_SMS)


# ---------------------------------------------------------------------------
# The thread-to-micro-tile map
# ---------------------------------------------------------------------------


def _threads():
    """(rg, cg) of the 128 threads of a block (attn_f32.cuh)."""
    tid = np.arange(fa.F32_THREADS)
    lane, warp = tid % 32, tid // 32
    return 4 * warp + lane // 8, lane % 8


def _formed_pairs(plan, bh, s):
    """Every (row, column) term the plan's blocks form over all their tiles,
    with the kernel's mask: (count of each unmasked (head, query, key) pair,
    True if every unmasked term lies inside the heads and S, True if every
    forward row meets a real key in every tile).

    Micro-tiles: thread (rg, cg) forms rows rg + 16·i with columns cg + 8·j
    of every tile. One row a thread: thread t forms row t with every column
    of each tile up to the last real one (the loop stops there)."""
    if plan.layout == "rows":
        r = np.arange(plan.threads)[:, None] + 0 * np.arange(plan.cols)
        c = np.arange(plan.cols)[None, :] + 0 * r
    else:
        rg, cg = _threads()
        ri, cj = plan.rows_per_thread, plan.cols_per_thread
        r = (rg[:, None, None] + 16 * np.arange(ri)[None, :, None]) + 0 * np.arange(cj)
        c = (cg[:, None, None] + 8 * np.arange(cj)[None, None, :]) + 0 * r
    rows_head, cols_head = plan.rows // plan.heads, plan.cols // plan.heads
    counts = np.zeros(bh * s * s, dtype=np.int64)
    inside, row_has_key = True, True
    n_tiles = -(-s // cols_head)
    for block in range(plan.blocks):
        head0 = block // plan.row_tiles * plan.heads
        first = block % plan.row_tiles * rows_head
        rh, ridx = head0 + r // rows_head, first + r % rows_head
        for t in range(n_tiles):
            ch, cidx = head0 + c // cols_head, t * cols_head + c % cols_head
            masked = cidx >= s
            if plan.kernel == "fwd" and plan.heads > 1:
                masked |= ch != rh
            real_row = (rh < bh) & (ridx < s)
            if plan.kernel == "fwd":
                # the row max is taken over the row's eight lanes
                per_row = (~masked).reshape(16, 8, plan.rows_per_thread, plan.cols_per_thread)
                row_has_key &= bool(per_row.any(axis=(1, 3)).all())
            used = ~masked & real_row
            inside &= bool(((ch[used] < bh) & (cidx[used] < s) & (ch[used] == rh[used])).all())
            query, key = (cidx, ridx) if plan.kernel == "bwd_dkv" else (ridx, cidx)
            np.add.at(counts, ((rh * s + query) * s + key)[used], 1)
    return counts, inside, row_has_key


def _written(plan, bh, s, d):
    """How often each (head, row, column) output is written: lane cg stores
    the float4 chunks cg + 8k (staged) or c with c % 8 == cg (lane sums) of
    each of its rows that lies inside the heads and S; one row a thread
    stores its whole row."""
    rows_head = plan.rows // plan.heads
    if plan.layout == "rows":
        rg, cg = np.arange(plan.threads), np.zeros(plan.threads, dtype=np.int64)
        row_of = [rg]
        chunks = [np.full(plan.threads, c) for c in range(d // 4)]
    else:
        rg, cg = _threads()
        row_of = [rg + 16 * i for i in range(plan.rows_per_thread)]
        if plan.layout == "staged":
            chunks = [cg + 8 * k for k in range(d // 32)]
        else:
            chunks = [np.where(cg == c % 8, c, -1) for c in range(d // 4)]
    counts = np.zeros(bh * s * d, dtype=np.int64)
    for block in range(plan.blocks):
        head0 = block // plan.row_tiles * plan.heads
        first = block % plan.row_tiles * rows_head
        for r in row_of:
            h, idx = head0 + r // rows_head, first + r % rows_head
            stored = (h < bh) & (idx < s)
            for chunk in chunks:
                ok = stored & (chunk >= 0)
                for e in range(4):
                    np.add.at(counts, ((h * s + idx) * d + 4 * chunk + e)[ok], 1)
    return counts


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", [16, 200, 300, 1024])
@pytest.mark.parametrize("kernel", fa.F32_KERNELS)
def test_every_pair_formed_once_and_every_output_written_once(kernel, s, d):
    bh = 5 if s <= 32 else 2  # five heads: a partial group of heads a block at S <= 32
    plan = fa.f32_plan(kernel, bh, s, d, H100_SMS)
    counts, inside, row_has_key = _formed_pairs(plan, bh, s)
    assert counts.min() == 1 and counts.max() == 1, plan
    assert inside and row_has_key, plan
    written = _written(plan, bh, s, d)
    assert written.min() == 1 and written.max() == 1, plan


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("s,bh", [(16, 601), (200, 140)])
def test_forward_on_a_large_grid_forms_every_pair_once(s, bh, d):
    """Beyond F32_SMALL_GRID_PER_SM blocks an SM the forward at D <= 16 takes
    its larger tile."""
    plan = fa.f32_plan("fwd", bh, s, d, H100_SMS)
    assert (plan.rows_per_thread, plan.cols_per_thread) == fa.F32_TILES["fwd"][d]
    small = fa.f32_plan("fwd", bh // 8, s, d, H100_SMS)
    assert small.rows_per_thread == fa.F32_FWD_SMALL_TILES[d][0]
    counts, inside, row_has_key = _formed_pairs(plan, bh, s)
    assert counts.min() == 1 and counts.max() == 1, plan
    assert inside and row_has_key, plan
    written = _written(plan, bh, s, d)
    assert written.min() == 1 and written.max() == 1, plan


@pytest.mark.parametrize("ri,cj", [(4, 8), (2, 8), (4, 4), (2, 4)])
def test_staged_weights_fill_each_slot_once_and_are_read_by_their_row(ri, cj):
    """stage(): thread (rg, cg) puts w[i][j] at [cg + 8j][rg·RI + i]; staged_sums
    reads row (rg, i) of every column there: a bijection onto the [C][R] tile,
    and each row reads back exactly the weights its own pairs wrote."""
    rg, cg = _threads()
    rows, cols, wstride = 16 * ri, 8 * cj, 16 * ri + 4
    i, j = np.arange(ri)[None, :, None], np.arange(cj)[None, None, :]
    slot = (cg[:, None, None] + 8 * j) * wstride + rg[:, None, None] * ri + i
    row, col = rg[:, None, None] + 16 * i, cg[:, None, None] + 8 * j
    slot, row, col = np.broadcast_arrays(slot, row, col)
    assert len(np.unique(slot)) == slot.size == rows * cols
    # the row and column that the reader of each slot takes it for
    read_col, read_row = slot // wstride, (slot % wstride) // ri + 16 * ((slot % wstride) % ri)
    np.testing.assert_array_equal(read_col, col)
    np.testing.assert_array_equal(read_row, row)


def test_row_reductions_stay_within_a_row_group():
    """The xor-shuffles 1, 2, 4 over the lanes of a row group meet only lanes
    of the same row group, and every column group once."""
    rg, cg = _threads()
    lane = np.arange(fa.F32_THREADS) % 32
    base = np.arange(fa.F32_THREADS) - lane
    for mask in (1, 2, 4):
        partner = base + (lane ^ mask)
        np.testing.assert_array_equal(rg[partner], rg)
    group = {tuple(sorted(cg[rg == g])) for g in range(16)}
    assert group == {tuple(range(8))}


# ---------------------------------------------------------------------------
# The forward's arithmetic, in the kernel's order
# ---------------------------------------------------------------------------


def _emulate_forward(q, k, v, scale, d):
    """The f32 forward of one head a block, in numpy float32 and in the
    kernel's order: logits by depth-ascending sums, scaled after the dot;
    per key tile of 8·CJ the row max over the tile, alpha = exp(m − m_new),
    each lane's share of Σ and of the output rescaled, p = exp(logit − m_new)
    summed by each lane over its keys cg + 8j in j order; the output by lane
    (lane sums, D <= 16) or over the tile's keys in order (staged); the eight
    lanes added by the xor-butterfly; the division by Σ last."""
    f32 = np.float32
    _, cj = fa.F32_TILES["fwd"][d]
    cols = 8 * cj
    bh, s, _ = q.shape
    staged = d >= fa.F32_STAGED_FROM
    m = np.full((bh, s), -np.inf, dtype=f32)
    lsum = np.zeros((bh, s, 8), dtype=f32)
    o = np.zeros((bh, s, d) if staged else (bh, s, 8, d), dtype=f32)
    for k0 in range(0, s, cols):
        kt = np.zeros((bh, cols, d), dtype=f32)
        vt = np.zeros((bh, cols, d), dtype=f32)
        n = min(cols, s - k0)
        kt[:, :n], vt[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
        x = np.zeros((bh, s, cols), dtype=f32)
        for dd in range(d):
            x = (x + q[:, :, dd, None] * kt[:, None, :, dd]).astype(f32)
        x = (x * f32(scale)).astype(f32)
        x[:, :, n:] = -np.inf
        m_new = np.maximum(m, x.max(axis=-1))
        alpha = np.exp(m - m_new).astype(f32)
        lsum = (lsum * alpha[..., None]).astype(f32)
        o = (o * (alpha[..., None] if staged else alpha[..., None, None])).astype(f32)
        m = m_new
        p = np.exp(x - m_new[..., None]).astype(f32)
        for j in range(cj):
            for cg in range(8):
                c = cg + 8 * j
                lsum[..., cg] = (lsum[..., cg] + p[..., c]).astype(f32)
                if not staged:
                    o[..., cg, :] = (o[..., cg, :] + p[..., c, None] * vt[:, None, c]).astype(f32)
        if staged:
            for c in range(cols):
                o = (o + p[..., c, None] * vt[:, None, c]).astype(f32)

    def butterfly(a, axis):
        for mask in (1, 2, 4):
            a = (a + np.take(a, np.arange(8) ^ mask, axis=axis)).astype(f32)
        return np.take(a, 0, axis=axis)

    total = butterfly(lsum, -1)
    o = o if staged else butterfly(o, -2)
    return (o / total[..., None]).astype(f32), m, total


@pytest.mark.parametrize("s,d", [(16, 32), (200, 16), (300, 64), (1024, 8), (100, 128),
                                 (520, 32)])
def test_forward_emulation_matches_the_plain_version(s, d):
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.standard_normal((2, 3, s, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    out, m, total = _emulate_forward(*(a.reshape(6, s, d) for a in (q, k, v)), scale, d)
    ref, ref_m, ref_s = fa.attention_reference(*map(torch.from_numpy, (q, k, v)), scale,
                                               with_stats=True)
    ref = ref.numpy().reshape(6, s, d)
    assert np.abs(out - ref).max() <= REL_TOL * np.abs(ref).max()
    assert np.abs(m - ref_m.numpy().reshape(6, s)).max() <= M_ATOL
    assert (np.abs(total - ref_s.numpy().reshape(6, s)) / total).max() <= SUM_RTOL


def test_forward_emulation_matches_the_pallas_forward():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 4, 256, 16)).astype(np.float32) for _ in range(3))
    scale = 0.25
    ref_out, ref_m, ref_s = (np.asarray(a).reshape(4, 256, -1) for a in _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True, with_stats=True))
    out, m, total = _emulate_forward(*(a.reshape(4, 256, 16) for a in (q, k, v)), scale, 16)
    assert np.abs(out - ref_out).max() <= REL_TOL * np.abs(ref_out).max()
    assert np.abs(m - ref_m[..., 0]).max() <= M_ATOL
    assert (np.abs(total - ref_s[..., 0]) / total).max() <= SUM_RTOL
