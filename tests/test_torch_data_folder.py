"""The port's image-folder loader and its C++ data binding, against the JAX
package's.

* ``load_image_folder`` is bit-equal to the JAX one (the same PIL resize and
  the same float32 arithmetic) on trees of gray, RGB, RGBA and non-square
  PNGs, and ``get_data`` sends every non-MNIST path there;
* the port's binding (its own copy of the C++ source, built into
  ``build/torch_native/``) parses, permutes and gathers exactly as the JAX
  package's binding and as the port's numpy path. These need ``g++`` and skip
  without it.
"""

import shutil

import numpy as np
import pytest
from PIL import Image

from aliasfree_diffusion_models_pytorch_tpu import data as jdata
from aliasfree_diffusion_models_pytorch_tpu.utils import native as jnative
from aliasfree_diffusion_models_pytorch_tpu_torch import data as tdata
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import native


def _save(path, array, mode=None):
    Image.fromarray(array, mode=mode).save(path)


def _tree(root, kind):
    """Two classes of three images, a text file in each, and a stray file at
    the root (only class directories are read)."""
    rng = np.random.default_rng({"gray": 1, "rgb": 2, "wide": 3}[kind])
    for cls in ("b_cls", "a_cls"):
        d = root / cls
        d.mkdir(parents=True)
        (d / "notes.txt").write_text("not an image")
        for i in range(3):
            if kind == "gray":
                _save(d / f"{i}.png", rng.integers(0, 256, (8, 8), dtype=np.uint8))
            elif kind == "rgb":
                shape = (8, 8, 4) if i == 0 else (8, 8, 3)  # RGBA becomes RGB
                _save(d / f"{i}.PNG", rng.integers(0, 256, shape, dtype=np.uint8))
            else:  # non-square: the shorter edge goes to image_size
                _save(d / f"{i}.png", rng.integers(0, 256, (12, 20, 3), dtype=np.uint8))
    (root / "stray.png").write_bytes(b"")


@pytest.mark.parametrize("kind,size,shape", [("gray", 8, (6, 8, 8, 1)),
                                             ("rgb", 8, (6, 8, 8, 3)),
                                             ("gray", 16, (6, 16, 16, 1)),
                                             ("wide", 8, (6, 8, 13, 3))])
def test_load_image_folder_is_bit_equal_to_the_jax_one(tmp_path, kind, size, shape):
    _tree(tmp_path, kind)
    ours = tdata.load_image_folder(str(tmp_path), size)
    theirs = jdata.load_image_folder(str(tmp_path), size)
    assert ours.images.shape == shape and ours.images.dtype == np.float32
    np.testing.assert_array_equal(ours.images, theirs.images)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.labels.tolist() == [0, 0, 0, 1, 1, 1]  # sorted class directories
    assert ours.images.min() >= -1.0 and ours.images.max() <= 1.0


def test_get_data_reads_an_image_tree(tmp_path):
    _tree(tmp_path, "rgb")
    dl, ds = tdata.get_data("CIFAR10", str(tmp_path), 8, 4, seed=1)
    _, jds = jdata.get_data("CIFAR10", str(tmp_path), 8, 4, seed=1)
    np.testing.assert_array_equal(ds.images, jds.images)
    assert len(dl) == 2
    with pytest.raises(FileNotFoundError, match="no class subdirectories"):
        tdata.load_image_folder(str(tmp_path / "a_cls"), 8)


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native library")
    built = native.load_native()
    assert built is not None, "g++ is here but the native library did not build"
    return built


def _csv(path, n, seed):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 10, (n, 1)), rng.integers(0, 256, (n, 784))], axis=1)
    header = ",".join(["label"] + [f"p{i}" for i in range(784)])
    np.savetxt(path, rows, fmt="%d", delimiter=",", header=header, comments="")
    return rows


def test_port_builds_its_own_copy_into_its_build_directory(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert (path.parent.name, path.parent.parent.name) == ("torch_native", "build")
    assert native.SOURCE.parent.parent.name == "aliasfree_diffusion_models_pytorch_tpu_torch"
    assert native.native_status() == "loaded"


def test_csv_parse_equals_the_jax_binding_and_the_numpy_path(tmp_path, lib, monkeypatch):
    path = tmp_path / "mnist.csv"
    rows = _csv(path, 13, seed=4)
    labels, pixels = native.parse_label_pixel_csv(str(path))
    np.testing.assert_array_equal(labels, rows[:, 0])
    if jnative.native_available():
        jl, jp = jnative.parse_label_pixel_csv(str(path))
        np.testing.assert_array_equal(labels, jl)
        np.testing.assert_array_equal(pixels, jp)
    with_native = tdata.load_mnist_csv(str(path), 32)
    monkeypatch.setattr(native, "parse_label_pixel_csv", lambda *a, **k: None)
    with_numpy = tdata.load_mnist_csv(str(path), 32)
    np.testing.assert_array_equal(with_native.images, with_numpy.images)
    np.testing.assert_array_equal(with_native.labels, with_numpy.labels)


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (2, 7, 3), (97, 42, 5), (4096, 123, 11)])
def test_permutation_equals_the_jax_binding_and_numpy(lib, n, seed, epoch):
    perm = native.shuffled_permutation(n, seed, epoch)
    np.testing.assert_array_equal(perm, tdata.splitmix64_permutation(n, seed, epoch))
    np.testing.assert_array_equal(perm, jdata.splitmix64_permutation(n, seed, epoch))
    if jnative.native_available():
        np.testing.assert_array_equal(perm, jnative.shuffled_permutation(n, seed, epoch))


def test_gather_and_dataloader_equal_the_numpy_path(lib, monkeypatch):
    images = np.random.default_rng(0).standard_normal((37, 4, 4, 3)).astype(np.float32)
    perm = native.shuffled_permutation(37, 1, 0)
    np.testing.assert_array_equal(native.gather_batch(images, perm, 8, 16), images[perm[8:24]])
    ds = tdata.ArrayDataset(images, np.arange(37, dtype=np.int32))
    loader = tdata.Dataloader(ds, 8, seed=3)
    fast = [b for _ in range(2) for b in loader]  # two epochs: the second reshuffles
    monkeypatch.setattr(native, "load_native", lambda build=True: None)
    loader = tdata.Dataloader(ds, 8, seed=3)
    slow = [b for _ in range(2) for b in loader]
    assert len(fast) == len(slow) == 10
    for (fi, fl), (si, sl) in zip(fast, slow):
        np.testing.assert_array_equal(fi, si)
        np.testing.assert_array_equal(fl, sl)
