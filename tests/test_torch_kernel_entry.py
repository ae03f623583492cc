"""The seam between the port's op modules and its CUDA kernel libraries
(``utils/kernels.py``, ``csrc/entry.cuh``), checked on the CPU.

* Every entry point's C parameter list, parsed out of ``csrc/``, against the
  argument kinds its :class:`kernels.Entry` declares: a mismatch there does
  not raise on the card, it passes a cut pointer or a wrong integer.
* The error decoder is defined once, in the shared header.
* No source of ``csrc/`` or ``ops/`` writes an SM count: every launcher that
  sizes by it takes ``kernels.sm_count``, and the f32 forward's small-grid
  rule scales with it.
* :func:`kernels.on_card`, the wrappers' one device check.
* ``chip_smoke.py``'s names for the kernels of a ptxas report, whatever the
  hashes of the source in the anonymous namespace's mangled name.

Imports no JAX.
"""

import importlib.util
import io
import pathlib
import re
import tokenize

import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import layer_norm as ln
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = kernels.CSRC.parent

ENTRIES = {"flash_fwd": fa._FWD, "flash_bwd": fa._BWD, "exp_chain": kp._EXP_CHAIN,
           "qk_rowsum": kp._QK_ROWSUM, "plain_gelu": tr._PLAIN_GELU,
           "filtered_gelu": tr._FILTERED_GELU, "layer_norm": ln._LAYER_NORM}

# The entry points that size their grids by the card's SM count, and so take it as `int sms`.
TAKE_SMS = ("flash_fwd", "exp_chain", "plain_gelu", "layer_norm")


def _c_kind(param: str):
    """The ctypes kind of one C parameter declaration."""
    if "*" in param:
        return kernels.PTR
    words = param.split()[:-1]
    kinds = {("long", "long"): kernels.I64, ("int",): kernels.INT, ("float",): kernels.F32}
    return kinds[tuple(words)]


def _c_params(name: str) -> list[str]:
    src = (kernels.CSRC / kernels.SOURCES[name]).read_text()
    found = re.findall(rf'extern "C" int afdm_{name}\(([^)]*)\)', src)
    assert len(found) == 1, name
    return [" ".join(p.split()) for p in found[0].split(",")]


def _code(path: pathlib.Path) -> str:
    """The source without its comments (C++ `//` and `/* */`, Python `#`) and,
    in Python, without its strings."""
    text = path.read_text()
    if path.suffix == ".py":
        kept = [tok.string for tok in tokenize.generate_tokens(io.StringIO(text).readline)
                if tok.type not in (tokenize.COMMENT, tokenize.STRING)]
        return " ".join(kept)
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def test_every_library_has_one_declared_entry():
    assert set(ENTRIES) == set(kernels.SOURCES)
    assert all(entry.name == name for name, entry in ENTRIES.items())


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_declared_argtypes_match_the_c_signature(name):
    params = _c_params(name)
    assert params[-1] == "void* stream", params
    declared = ENTRIES[name].argtypes
    assert len(declared) == len(params) - 1, (name, params)
    for param, kind in zip(params[:-1], declared):
        assert _c_kind(param) is kind, (name, param, kind)
    assert ("int sms" in params) == (name in TAKE_SMS), (name, params)


def test_the_error_decoder_is_defined_once_in_the_header():
    header = (kernels.CSRC / "entry.cuh").read_text()
    definition = 'extern "C" const char* afdm_cuda_error_string(int err) {'
    assert header.count(definition) == 1
    code = re.search(r"constexpr int kTensorMapError = (\d+);", header)
    assert code and int(code.group(1)) == kernels.TENSOR_MAP_ERROR
    for source in kernels.SOURCES.values():
        text = (kernels.CSRC / source).read_text()
        assert "afdm_cuda_error_string" not in text, source
        assert '#include "entry.cuh"' in text, source
    for other in kernels.CSRC.glob("*.cuh"):
        if other.name != "entry.cuh":
            assert "afdm_cuda_error_string" not in other.read_text(), other.name


def test_no_source_hard_codes_an_sm_count():
    files = sorted(kernels.CSRC.glob("*.cu*")) + sorted((PKG / "ops").glob("*.py"))
    assert len(files) > 12
    for path in files:
        code = _code(path)
        for sms in ("132", "114", "144"):  # H100 SXM, H100 PCIe, the full GH100 die
            assert not re.search(rf"\b{sms}\b", code), (path.name, sms)
    # the device is asked in one place, kernels.sm_count; the qk_rowsum probe's launch reads the
    # attribute only to refuse a plan made for another card
    readers = [p.relative_to(REPO).as_posix() for p in sorted(PKG.rglob("*.py"))
               + [REPO / "chip_smoke.py"] if "multi_processor_count" in p.read_text()]
    assert readers == [f"{PKG.name}/utils/kernels.py"]
    assert (PKG / "utils" / "kernels.py").read_text().count("multi_processor_count") == 1
    readers = [p.name for p in sorted(kernels.CSRC.glob("*.cu*"))
               if "cudaDevAttrMultiProcessorCount" in p.read_text()]
    assert readers == ["qk_rowsum.cu"]


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("sms,limit", [(132, 528), (114, 456)])
def test_f32_forward_small_grid_scales_with_the_sm_count(sms, limit, d):
    """At D <= 16 the f32 forward takes its small tile up to 4 blocks of 64
    queries an SM: 528 on an H100 SXM (the plans pinned before the SM count was
    an argument), 456 on an H100 PCIe."""
    assert fa.F32_SMALL_GRID_PER_SM * sms == limit
    small, large = fa.F32_FWD_SMALL_TILES[d], fa.F32_TILES["fwd"][d]
    for bh, s, tile in ((limit, 64, small), (limit + 1, 64, large), (limit // 4, 256, small),
                        (limit // 4 + 1, 256, large)):
        plan = fa.f32_plan("fwd", bh, s, d, sms)
        assert (plan.rows_per_thread, plan.cols_per_thread) == tile, (bh, s, plan)
    # the backward passes do not depend on it
    for kernel in ("bwd_dq", "bwd_dkv"):
        assert fa.f32_plan(kernel, limit + 1, 64, d, sms) == fa.f32_plan(kernel, limit + 1, 64,
                                                                         d, 1)


def test_on_card_sends_cpu_to_the_plain_version_and_refuses_other_devices():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert kernels.on_card(cpu, "fn") is False
    with pytest.raises(ValueError, match="fn runs on cpu or cuda, got meta"):
        kernels.on_card(meta, "fn")
    with pytest.raises(ValueError, match="fn runs on cuda, got cpu"):
        kernels.on_card(cpu, "fn", cpu=False)
    with pytest.raises(ValueError, match="fn runs on cuda, got meta"):
        kernels.on_card(meta, "fn", cpu=False)


@pytest.mark.parametrize("mangled,label", [
    # the namespace's second hash starts with digits that read as a length (36 = 8 + 28)
    ("_ZN50_GLOBAL__N__5a1b2c3d_12_flash_bwd_cu_36bca9c128flash_bwd_dq_f32_rows_kernelILi16EEEvPKfS2_",
     "flash_bwd_dq_f32_rows_kernel<16>"),
    ("_ZN50_GLOBAL__N__5a1b2c3d_12_flash_bwd_cu_0bca9c1228flash_bwd_dq_f32_rows_kernelILi8EEEvPKfS2_",
     "flash_bwd_dq_f32_rows_kernel<8>"),
    ("_ZN50_GLOBAL__N__12345678_12_flash_fwd_cu_1234567820flash_fwd_f32_kernelILi8ELi4ELi4ELi4EEEvPKf",
     "flash_fwd_f32_kernel<8, 4, 4, 4>"),
    ("_Z16qk_rowsum_kernelILi8EEv14CUtensorMap_stS0_Pfii", "qk_rowsum_kernel<8>"),
])
def test_chip_smoke_names_a_kernel_whatever_the_source_hash(mangled, label):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.kernel_label(mangled) == label
