"""What surrounds the port's CUDA kernels, on the CPU: the bf16 launch plans
and scratch arrays that the wrappers hand to the kernels, the checks they make
before a launch, the build's cache key, and ``qk_rowsum``'s plan (its table
parsed out of the source, its shared memory against the card's limit and the
TMA rules, a numpy simulation of its grid's query map, its issued FLOPs).

The kernels themselves have no CPU mode (``tests/test_torch_cuda_kernels.py``
runs them on a card); everything here is plain Python that a launch goes
through, so a wrong plan or a stale library shows without one.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels


@pytest.mark.parametrize("s,heads,warps,keys,q_tiles", [
    (16, 4, 1, 16, 1),      # sampling sa3: one warp a head, four heads a block
    (32, 2, 2, 32, 1),
    (64, 1, 4, 64, 1),      # sa2, sa4: one head, 64 rows a block
    (256, 1, 4, 64, 4),     # sa1, sa5
    (1024, 1, 4, 64, 16),   # sa6
    (4096, 1, 4, 64, 64),   # sa6 of the 64-px step
])
def test_forward_plan_fills_every_warp_with_real_rows(s, heads, warps, keys, q_tiles):
    bh = 1024
    plan = fa.fwd_plan(bh, s, 64)
    # the depths below 128 share one plan
    assert all(fa.fwd_plan(bh, s, d) == plan for d in fa.HEAD_DIMS if d < 128)
    assert (plan.heads_per_block, plan.warps_per_head, plan.keys_per_tile,
            plan.q_tiles) == (heads, warps, keys, q_tiles)
    assert plan.blocks == bh // heads * q_tiles
    # the block's 64 K/V rows are shared out among its heads, and its warps
    # cover every query of each head with less than one block of rows to spare
    assert plan.heads_per_block * plan.keys_per_tile == fa.WARPS * fa.ROWS_PER_WARP
    assert plan.heads_per_block * plan.warps_per_head == fa.WARPS
    rows = plan.warps_per_head * fa.ROWS_PER_WARP * plan.q_tiles
    assert s <= rows < s + fa.WARPS * fa.ROWS_PER_WARP
    if heads > 1:  # no warp stands on rows past S only
        assert s > (plan.warps_per_head - 1) * fa.ROWS_PER_WARP


@pytest.mark.parametrize("s", [16, 32, 256, 1024])
def test_forward_plan_at_head_dim_128_takes_one_head_a_block(s):
    """The D = 128 kernel (the 128-px UNet's sa2, sa3) has no several-head
    instantiation; the other depths keep their plan."""
    plan = fa.fwd_plan(64, s, 128)
    assert plan.heads_per_block == 1 and plan.warps_per_head == fa.WARPS
    assert plan.q_tiles == -(-s // (fa.WARPS * fa.ROWS_PER_WARP)) and plan.blocks == 64 * plan.q_tiles
    assert fa.fwd_plan(64, s, 64).heads_per_block == (4 if s <= 16 else 2 if s <= 32 else 1)
    # the backward takes the same depths: its scratch at D = 128
    assert 128 in fa.HEAD_DIMS
    assert fa.bwd_scratch_shapes(64, s, 128, torch.bfloat16)["dq_acc"] == ((64, s, 128),
                                                                           torch.float32)


def test_forward_plan_rounds_up_a_partial_group_of_heads():
    assert fa.fwd_plan(6, 16, 32).blocks == 2   # four heads, then two
    assert fa.fwd_plan(3, 32, 32).blocks == 2
    assert fa.fwd_plan(3, 200, 32).blocks == 3 * 4
    with pytest.raises(ValueError):
        fa.fwd_plan(0, 16, 32)


@pytest.mark.parametrize("dtype,expect", [
    (torch.bfloat16, {"consts": ((64, 300, 4), torch.float32),
                      "dq_acc": ((64, 300, 16), torch.float32),
                      "g_scaled": ((64, 300, 16), torch.bfloat16)}),
    (torch.float32, {"consts": ((64, 300, 4), torch.float32)}),
])
def test_backward_scratch_shapes(dtype, expect):
    shapes = fa.bwd_scratch_shapes(64, 300, 16, dtype)
    assert shapes == expect
    assert list(shapes) == list(expect)  # the order afdm_flash_bwd takes them in
    # every scratch row is a whole number of 16-byte cp.async chunks
    for shape, dt in shapes.values():
        assert shape[-1] * torch.finfo(dt).bits // 8 % fa.ALIGN == 0


def test_bf16_launch_checks_alignment_and_scale():
    flat = torch.zeros(4 * 64 * 8 + 8, dtype=torch.bfloat16)
    good = flat[:-8].view(1, 4, 64, 8)
    assert good.data_ptr() % fa.ALIGN == 0
    fa._check_bf16_launch(0.35, q=good, k=good)
    bad = flat[1:-7].view(1, 4, 64, 8)  # contiguous, 2 bytes past a 16-byte boundary
    assert bad.is_contiguous()
    with pytest.raises(ValueError, match="k must be 16-byte aligned"):
        fa._check_bf16_launch(0.35, q=good, k=bad)
    with pytest.raises(ValueError, match="positive scale"):
        fa._check_bf16_launch(-0.35, q=good)
    # a CPU tensor never reaches the check: the plain version takes it
    torch.testing.assert_close(fa.flash_attention_fwd(bad, bad, bad),
                               fa.attention_reference(bad, bad, bad), rtol=0, atol=0)


def test_an_edited_shared_header_renames_every_library_that_may_include_it(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["attn_f32.cuh", "entry.cuh", "gelu.cuh", "mma_bf16.cuh",
                                         "sm90.cuh"]
    before = {name: kernels.library_path(name, csrc) for name in kernels.SOURCES}
    assert before == {name: kernels.library_path(name) for name in kernels.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: kernels.library_path(name, csrc) for name in kernels.SOURCES}
    assert all(after[n] != before[n] for n in kernels.SOURCES)
    # an edited source renames its own library only
    (csrc / kernels.SOURCES["exp_chain"]).write_text(
        (csrc / kernels.SOURCES["exp_chain"]).read_text() + "\n// edited\n")
    again = {name: kernels.library_path(name, csrc) for name in kernels.SOURCES}
    assert [n for n in kernels.SOURCES if again[n] != after[n]] == ["exp_chain"]


# ---- qk_rowsum (csrc/qk_rowsum.cu) ----

SMEM_PER_BLOCK = 232448  # 227 KB: the most dynamic shared memory a block may take on an H100
H100_SMS = 132


def test_qk_plan_mirrors_the_kernel_source():
    src = (kernels.CSRC / kernels.SOURCES["qk_rowsum"]).read_text()
    tiles = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        r"struct Tile<(\d+)> \{\s*static constexpr int kAccKeys = (\d+), kStages = (\d+), "
        r"kSwizzle = (\d+), kBlocksPerSm = (\d+);", src)}
    assert tiles == kp.QK_TILES
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kKeys"]) == kp.QK_KEYS
    assert int(consts["kConsumers"]) == kp.QK_WARPGROUPS
    assert int(consts["kRowTiles"]) == kp.QK_ROW_TILES
    assert int(consts["kAlign"]) == kp.QK_ALIGN
    entry = (kernels.CSRC / "entry.cuh").read_text()
    assert int(re.search(r"constexpr int kTensorMapError = (\d+);", entry).group(1)) == \
        kernels.TENSOR_MAP_ERROR
    assert "afdm::kTensorMapError + static_cast<int>(res)" in src
    launch = {int(m[0]): int(m[1]) for m in re.findall(
        r"struct Registers<(\d+)> \{\s*static constexpr int kLaunch = (\d+),", src)}
    assert launch == kp.QK_LAUNCH_REGS
    assert {per_sm for *_, per_sm in kp.QK_TILES.values()} <= set(launch)


@pytest.mark.parametrize("d", kp.QK_HEAD_DIMS)
def test_qk_plan_fits_shared_memory_and_the_tma_rules(d):
    """The layout the TMA rules allow for the kernel's swizzle (parsed out of
    its source), against the plan's shared memory, which the launch checks
    equal to the kernel's own."""
    plan = kp.qk_plan(1024, 1024, d, sms=H100_SMS)
    *_, per_sm = kp.QK_TILES[d]
    assert per_sm * plan.smem_bytes <= SMEM_PER_BLOCK
    # a key box: its inner extent at most the swizzle width (d = 8: rows of 16 bytes, no swizzle)
    box_cols = min(d, plan.swizzle // 2) if plan.swizzle else d
    boxes = d // box_cols
    assert boxes * box_cols == d and box_cols <= 256 and plan.keys_per_tile <= 256
    box_bytes = plan.keys_per_tile * box_cols * 2
    # a stage: its key tile rounded up to the 1024 bytes a swizzled tile starts on
    stage_bytes = -(-boxes * box_bytes // 1024) * 1024
    q_tiles = kp.QK_WARPGROUPS * kp.QK_ROW_TILES
    q_box_bytes = d * 128  # d rows of 64 queries, 128-byte swizzled
    # a 16-byte-aligned dynamic base rounded up to 1024, the ring, the queries' tile, then a
    # full and an empty mbarrier a stage and for the queries' tile
    assert plan.smem_bytes >= (1024 - 16 + plan.stages * stage_bytes + q_tiles * q_box_bytes
                               + 8 * (2 * plan.stages + 2))
    key_starts = [i * stage_bytes + b * box_bytes for i in range(plan.stages)
                  for b in range(boxes)]
    q_starts = [plan.stages * stage_bytes + m * q_box_bytes for m in range(q_tiles)]
    assert all(start % 1024 == 0 for start in q_starts)
    row_bytes = box_cols * 2
    if plan.swizzle:
        assert row_bytes <= plan.swizzle and all(start % 1024 == 0 for start in key_starts)
        # every wgmma depth step (32 bytes of a row) lies inside one box row, and every key
        # chunk of a tile starts on a whole swizzle atom of 8 rows
        assert row_bytes % 32 == 0
        assert all(c * plan.acc_keys * row_bytes % (8 * row_bytes) == 0
                   for c in range(plan.keys_per_tile // plan.acc_keys))
    else:
        # d = 8: unswizzled, 8-row core matrices of 128 bytes
        assert d == 8 and row_bytes == 16 and all(start % 128 == 0 for start in key_starts)


def _qk_items(plan, s):
    """Per work item a consumer warpgroup takes, in the order the persistent
    blocks walk them: (block, group, first query of the warpgroup, active)."""
    q_blocks = -(-s // plan.queries_per_block)
    for block in range(plan.grid):
        for item in range(block, plan.items, plan.grid):
            g, qb = divmod(item, q_blocks)
            for wg in range(kp.QK_WARPGROUPS):
                q_wg = qb * plan.queries_per_block + wg * 64 * kp.QK_ROW_TILES
                yield block, g, q_wg, q_wg < s


@pytest.mark.parametrize("n,s,sms", [(1, 128, 132), (3, 384, 132), (2, 1024, 3),
                                     (1, 4096, 132), (7, 640, 4)])
def test_qk_plan_grid_writes_every_query_once(n, s, sms):
    """The kernel's thread map in numpy: persistent blocks walk the items
    (group, block of 256 queries) blockIdx.x, + gridDim.x, ...; in an item,
    consumer warpgroup wg (idle where its 128 queries start past s), query
    tile mt, warp, the lane's row group and half h; lanes of quad 0 write."""
    plan = kp.qk_plan(n, s, 32, sms=sms)
    assert plan.grid == min(plan.items, sms * kp.QK_TILES[32][3])
    mt, warp, group, h = np.meshgrid(np.arange(kp.QK_ROW_TILES), np.arange(4), np.arange(8),
                                     np.arange(2), indexing="ij")
    rows = (64 * mt + 16 * warp + group + 8 * h).ravel()
    writes = np.zeros((n, s), dtype=np.int64)
    for _, g, q_wg, active in _qk_items(plan, s):
        if active:
            assert q_wg + rows.max() < s  # the A rows it reads, too
            np.add.at(writes[g], q_wg + rows, 1)
    assert (writes == 1).all()


@pytest.mark.parametrize("d", kp.QK_HEAD_DIMS)
def test_qk_plan_flop_count_adds_up_over_its_wgmmas(d):
    """The plan's FLOP arithmetic only: that the kernel forms the logits on
    the tensor cores shows on the card (chip_smoke's SASS check, and its time
    against the bound's FLOPs at the card's peak)."""
    n, s = 3, 384
    plan = kp.qk_plan(n, s, d, sms=H100_SMS)
    # one wgmma m64nNk16 per key tile, key chunk of N, depth step and query tile of every
    # active consumer warpgroup of every item
    warpgroups = sum(active for *_, active in _qk_items(plan, s))
    assert plan.keys_per_tile % plan.acc_keys == 0 and s % plan.keys_per_tile == 0
    products = (warpgroups * kp.QK_ROW_TILES * (s // plan.keys_per_tile)
                * (plan.keys_per_tile // plan.acc_keys) * (plan.depth // 16))
    assert products * 2 * 64 * plan.acc_keys * 16 == plan.issued_flops
    assert plan.issued_flops >= 2 * n * s * s * d
    if d == 8:
        assert plan.depth == 16 and plan.issued_flops == 2 * n * s * s * 16
    else:
        assert plan.issued_flops == 2 * n * s * s * d


@pytest.mark.parametrize("n,s,d", [(1, 128, 4), (1, 128, 24), (1, 128, 256), (1, 100, 8),
                                   (1, 192, 16), (1, 0, 32), (0, 128, 64), (2**23, 256, 128)])
def test_qk_plan_refuses_what_the_kernel_does_not_take(n, s, d):
    with pytest.raises(ValueError):
        kp.qk_plan(n, s, d, sms=H100_SMS)
