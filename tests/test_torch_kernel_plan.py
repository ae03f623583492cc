"""What surrounds the port's CUDA kernels, on the CPU: the bf16 launch plans
and scratch arrays that the wrappers hand to the kernels, the checks they make
before a launch, and the build's cache key.

The kernels themselves have no CPU mode (``tests/test_torch_cuda_kernels.py``
runs them on a card); everything here is plain Python that a launch goes
through, so a wrong plan or a stale library shows without one.
"""

import shutil

import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
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
    assert [h.name for h in headers] == ["attn_f32.cuh", "mma_bf16.cuh"]
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
