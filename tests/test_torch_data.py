"""The port's data layer against the JAX package's.

* Every transform helper and all four ``Transform`` kinds bit-equal to
  JAX's on the same seed, drawn in one thread (with more threads, which
  thread spawns which generator is not fixed).
* ``device_normalize_fn`` within 1e-6 of JAX's.
* The four parsers (CUB-200, Stanford Dogs, Flowers-102, FGVC-Aircraft) on
  tiny trees this file writes: the same paths, labels and pixels.
* ``ImageFileDataset.gather`` through ``pil``, ``native`` and
  ``native_fused`` bit-equal to JAX's on the same files (sklearn's two
  photographs and written JPEGs; both packages build the same
  ``decode.cpp``), the non-JPEG routing to PIL and the PIL retry of a file
  libjpeg rejects included; a decode pool that cannot be built raises.
* The CIFAR ``.npy`` loader of the training CLI against JAX's.
* ``FeatureBankCache`` files written by either package load in the other,
  and its chunks through the port's ``nw_streaming_log_probs`` give JAX's
  log-probs (rtol=atol=1e-5).
* The eval CLI's ``--bank_cache`` restores what it saved, with equal
  results; the serve CLI's restores on its own tag and refuses another,
  a cache written by the JAX server (other weights from the same seed)
  included.
"""

import argparse
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nwhead_tpu_torch import eval as eval_cli
from nwhead_tpu_torch import serve as serve_cli
from nwhead_tpu_torch import train as train_cli
from nwhead_tpu_torch.data import datasets as tdata
from nwhead_tpu_torch.data import transforms as TT
from nwhead_tpu_torch.data.embedding_cache import FeatureBankCache
from nwhead_tpu_torch.native import decode as tdecode
from nwhead_tpu_torch.nw.streaming import nw_streaming_log_probs

torch.set_num_threads(1)

KINDS = ("imagenet_train", "imagenet_eval", "cifar_train", "cifar_eval")


def _images(seed=0):
    """uint8 and float HWC images of several shapes (portrait, landscape,
    square, smaller than the crop)."""
    rng = np.random.default_rng(seed)
    shapes = [(48, 40, 3), (30, 64, 3), (32, 32, 3), (20, 28, 3)]
    u8 = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    return u8 + [x.astype(np.float32) / 255.0 for x in u8[:2]]


def test_transform_helpers_match_jax():
    from nwhead_tpu.data import transforms as JT

    for img in _images():
        np.testing.assert_array_equal(TT.to_float(img), JT.to_float(img))
        f = TT.to_float(img)
        np.testing.assert_array_equal(TT.normalize(f, TT.CIFAR_MEAN, TT.CIFAR_STD),
                                      JT.normalize(f, JT.CIFAR_MEAN, JT.CIFAR_STD))
        for size in (7, 24, 33):
            np.testing.assert_array_equal(TT.resize_shorter_side(img, size),
                                          JT.resize_shorter_side(img, size))
            np.testing.assert_array_equal(TT.center_crop(img, size), JT.center_crop(img, size))
            np.testing.assert_array_equal(TT._resize_pil(img, (size, size + 3)),
                                          JT._resize_pil(img, (size, size + 3)))
        h, w = img.shape[:2]
        assert TT.center_eval_box(h, w, 16) == JT.center_eval_box(h, w, 16)
        ra, rb = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(20):
            assert TT.sample_rrc_box(h, w, ra) == JT.sample_rrc_box(h, w, rb)
            # A narrow ratio forces the fallback box now and then.
            assert (TT.sample_rrc_box(h, w, ra, (0.9, 1.0), (3.9, 4.0))
                    == JT.sample_rrc_box(h, w, rb, (0.9, 1.0), (3.9, 4.0)))
        np.testing.assert_array_equal(TT.random_resized_crop(img, ra, 16),
                                      JT.random_resized_crop(img, rb, 16))
        np.testing.assert_array_equal(TT.random_crop_padded(img, ra, 16, 4),
                                      JT.random_crop_padded(img, rb, 16, 4))
    assert (TT.IMAGENET_MEAN, TT.IMAGENET_STD, TT.CIFAR_MEAN, TT.CIFAR_STD) == (
        JT.IMAGENET_MEAN, JT.IMAGENET_STD, JT.CIFAR_MEAN, JT.CIFAR_STD)


@pytest.mark.parametrize("kind,device_normalize", [
    (k, dn) for k in KINDS for dn in ((False, True) if k.startswith("imagenet") else (False,))])
def test_transform_kinds_match_jax(kind, device_normalize):
    """Same seed, one thread: the same images, boxes, flips and batches."""
    from nwhead_tpu.data import transforms as JT

    if kind.startswith("imagenet"):
        kw = dict(size=16, seed=5, device_normalize=device_normalize)
        images = _images(1) * 2
    else:
        kw = dict(seed=5)
        images = [np.random.default_rng(i).integers(0, 256, (32, 32, 3), dtype=np.uint8)
                  for i in range(6)]
    ours = getattr(TT, f"{kind}_transform")(**kw)
    theirs = getattr(JT, f"{kind}_transform")(**kw)
    assert ours.supports_fused_decode == theirs.supports_fused_decode
    for img in images:
        a, b = ours(img), theirs(img)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        if ours.supports_fused_decode:
            assert ours.crop_geometry(*img.shape[:2]) == theirs.crop_geometry(*img.shape[:2])
    if ours.supports_fused_decode:
        batch = np.random.default_rng(2).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
        flips = [True, False, True]
        np.testing.assert_array_equal(ours.finish_batch(batch.copy(), flips),
                                      theirs.finish_batch(batch.copy(), flips))
        np.testing.assert_array_equal(ours.finish_batch(batch.copy()),
                                      theirs.finish_batch(batch.copy()))
    else:
        with pytest.raises(ValueError):
            ours.crop_geometry(32, 32)


def test_device_normalize_fn_matches_jax():
    from nwhead_tpu.data import transforms as JT

    u8 = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    for mean, std in ((TT.IMAGENET_MEAN, TT.IMAGENET_STD), (TT.CIFAR_MEAN, TT.CIFAR_STD)):
        got = TT.device_normalize_fn(mean, std)(torch.from_numpy(u8))
        want = np.asarray(JT.device_normalize_fn(mean, std)(jnp.asarray(u8)))
        assert got.dtype == torch.float32 and got.shape == u8.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), TT.normalize(TT.to_float(u8), mean, std),
                                   rtol=0, atol=1e-6)


# -- the parsers -------------------------------------------------------------------


def _write_img(path, color, size=24):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.full((size, size, 3), color, dtype=np.uint8)
    arr[::3, ::2] = 255 - color  # some texture for the JPEG encoder
    Image.fromarray(arr).save(path)


def _cub_tree(root):
    lines_split, lines_img, lines_lbl = [], [], []
    for i in range(1, 7):
        label = 1 if i <= 3 else 2
        name = f"{label:03d}.Class/{i}.jpg"
        _write_img(os.path.join(root, "images", name), color=i * 30)
        lines_img.append(f"{i} {name}")
        lines_lbl.append(f"{i} {label}")
        lines_split.append(f"{i} {0 if i % 2 == 1 else 1}")
    for name, lines in (("images.txt", lines_img), ("image_class_labels.txt", lines_lbl),
                        ("train_test_split.txt", lines_split)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n\n")
    return (True, False)


def _dog_tree(root):
    rows = []
    for i, (name, lbl) in enumerate([("a/1.jpg", 1), ("b/2.jpg", 2), ("a/3.jpg", 1)]):
        _write_img(os.path.join(root, "Images", name), color=50 + i * 20)
        rows.append(f"{name},{lbl}")
    with open(os.path.join(root, "train_list.csv"), "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(root, "test_list.csv"), "w") as f:
        f.write(rows[1])
    return (True, False)


def _flower_tree(root):
    from scipy.io import savemat

    for i in range(1, 5):
        _write_img(os.path.join(root, "jpg", f"image_{i:05d}.jpg"), color=i * 40)
    savemat(os.path.join(root, "imagelabels.mat"), {"labels": np.array([[1, 2, 1, 2]])})
    savemat(os.path.join(root, "setid.mat"), {"trnid": np.array([[1, 2]]),
                                              "valid": np.array([[3]]),
                                              "tstid": np.array([[4]])})
    return ("train", "val", "test")


def _aircraft_tree(root):
    os.makedirs(os.path.join(root, "data", "images"))
    with open(os.path.join(root, "data", "variants.txt"), "w") as f:
        f.write("707-320\nA300B4\nBAe 146-200\n")
    rows = ["0001 707-320", "0002 A300B4", "0003 BAe 146-200", "0004 707-320"]
    for split, sel in (("trainval", rows[:3]), ("test", rows[3:])):
        with open(os.path.join(root, "data", f"images_variant_{split}.txt"), "w") as f:
            f.write("\n".join(sel))
    for i in range(1, 5):
        _write_img(os.path.join(root, "data", "images", f"{i:04d}.jpg"), color=i * 30)
    return ("trainval", "test")


PARSERS = {"Cub200Dataset": _cub_tree, "StanfordDogDataset": _dog_tree,
           "Flowers102Dataset": _flower_tree, "FGVCAircraftDataset": _aircraft_tree}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parsers_match_jax(tmp_path, name):
    from nwhead_tpu.data import datasets as jdata

    root = str(tmp_path / name)
    os.makedirs(root)
    for split in PARSERS[name](root):
        ours = getattr(tdata, name)(root, split, decoder="pil", workers=1)
        theirs = getattr(jdata, name)(root, split, decoder="pil", workers=1)
        assert ours.paths == theirs.paths and len(ours) > 0
        np.testing.assert_array_equal(ours.targets, theirs.targets)
        assert ours.num_classes == theirs.num_classes
        idx = np.arange(len(ours))
        np.testing.assert_array_equal(ours.gather(idx), theirs.gather(idx))


# -- the decoders ----------------------------------------------------------------


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """sklearn's two photographs (427 x 640 JPEGs), written JPEGs of other
    shapes, a PNG, and a PNG named ``.jpg`` (libjpeg rejects it, PIL reads
    it)."""
    from PIL import Image
    from sklearn.datasets import load_sample_images

    d = tmp_path_factory.mktemp("decode")
    jpegs = []
    for f in load_sample_images().filenames:
        jpegs.append(str(d / os.path.basename(f)))
        shutil.copyfile(f, jpegs[-1])
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((90, 60), (64, 160), (40, 40), (20, 30))):
        img = np.kron(rng.integers(0, 256, (h // 10, w // 10, 3)),
                      np.ones((10, 10, 1))).astype(np.uint8)
        jpegs.append(str(d / f"w{i}.JPEG"))
        Image.fromarray(img).save(jpegs[-1], format="JPEG", quality=90)
    png = str(d / "p.png")
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(png)
    fake = str(d / "png_named.jpg")
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(fake, format="PNG")
    return {"jpegs": jpegs, "png": png, "fake": fake}


DECODE_CASES = [(dec, kind) for dec in tdata.DECODERS
                for kind in ("imagenet_train", "imagenet_eval")]


@pytest.mark.parametrize("decoder,kind", DECODE_CASES)
def test_gather_matches_jax(image_files, decoder, kind):
    """One thread draws the train transform's numbers (workers=1); the eval
    transform draws none, so its gather runs on 3 workers. Batches of
    JPEGs, then one with a PNG (PIL for the batch), then one with the
    PNG named .jpg (libjpeg fails, PIL again)."""
    from nwhead_tpu.data import datasets as jdata
    from nwhead_tpu.data import transforms as JT

    workers = 1 if kind == "imagenet_train" else 3
    jpegs = image_files["jpegs"]
    paths = jpegs + [image_files["png"], image_files["fake"]]
    targets = np.arange(len(paths)) % 3
    ours = tdata.ImageFileDataset(paths, targets, 3, getattr(TT, f"{kind}_transform")(
        size=32, seed=4), workers=workers, decoder=decoder)
    theirs = jdata.ImageFileDataset(paths, targets, 3, getattr(JT, f"{kind}_transform")(
        size=32, seed=4), workers=workers, decoder=decoder)
    if decoder != "pil":
        assert theirs._native() is not None  # JAX's build, not its silent PIL fallback
    n = len(jpegs)
    for idx in (np.arange(n), np.arange(n)[::-1], [0, n], [1, n + 1], [2]):
        got, want = ours.gather(idx), theirs.gather(idx)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_native_decode_matches_jax_and_pil(image_files):
    from PIL import Image

    from nwhead_tpu.native import decode as jdecode

    jpegs = image_files["jpegs"]
    pool = tdecode.JpegDecodePool(3)
    bufs = pool.decode_batch(jpegs)
    for p, b, w in zip(jpegs, bufs, jdecode.JpegDecodePool(3).decode_batch(jpegs)):
        assert tdecode.jpeg_dims(p) == jdecode.jpeg_dims(p) == b.shape[:2]
        np.testing.assert_array_equal(b, w)
        with Image.open(p) as im:
            np.testing.assert_array_equal(b, np.asarray(im.convert("RGB")))
    boxes = np.array([[5, 7, 30, 25]] * len(jpegs), np.int32)
    flips = [i % 2 for i in range(len(jpegs))]
    np.testing.assert_array_equal(
        pool.decode_crop_resize(jpegs, boxes, (24, 20), flips=flips),
        jdecode.JpegDecodePool(2).decode_crop_resize(jpegs, boxes, (24, 20), flips=flips))
    with pytest.raises(IOError):
        pool.decode_batch([image_files["fake"]])


@pytest.mark.parametrize("failure", ["compiler error", "no g++"])
def test_failed_native_build_raises(image_files, tmp_path, monkeypatch, failure):
    """No fallback: a decode pool that cannot be built raises, naming
    libjpeg, where JAX's dataset would quietly decode with PIL."""
    bad = tmp_path / "decode.cpp"
    bad.write_text("#include <jpeglib_missing.h>\n")
    monkeypatch.setattr(tdecode, "SOURCE", bad)
    monkeypatch.setattr(tdecode, "BUILD_DIR", tmp_path / "build")
    if failure == "no g++":
        monkeypatch.setattr(tdecode.shutil, "which", lambda name: None)
    tdecode.load_library.cache_clear()
    try:
        for decoder in ("native", "native_fused"):
            ds = tdata.ImageFileDataset(image_files["jpegs"], [0] * len(image_files["jpegs"]), 1,
                                        TT.imagenet_eval_transform(size=16), decoder=decoder)
            with pytest.raises(RuntimeError, match="libjpeg"):
                ds.gather([0, 1])
    finally:
        tdecode.load_library.cache_clear()
    with pytest.raises(ValueError, match="decoder"):
        tdata.ImageFileDataset([], [], 1, decoder="turbo")


# -- CIFAR's .npy files ------------------------------------------------------------


def _write_cifar(data_dir, name, n_train=20, n_test=9):
    rng = np.random.default_rng(len(name))
    base = os.path.join(data_dir, name)
    os.makedirs(base, exist_ok=True)
    c = 10 if name == "cifar10" else 100
    for split, n in (("train", n_train), ("test", n_test)):
        np.save(os.path.join(base, f"{split}_images.npy"),
                rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        np.save(os.path.join(base, f"{split}_labels.npy"), rng.integers(0, c, n))


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_cifar_loader_matches_jax(tmp_path, name):
    import train as jax_train_cli

    _write_cifar(str(tmp_path), name)
    args = argparse.Namespace(dataset=name, data_dir=str(tmp_path), seed=3, workers=8,
                              decoder="native")
    ours, theirs = train_cli.build_datasets(args), jax_train_cli.build_datasets(args)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) and a.num_classes == b.num_classes == int(name[5:])
        np.testing.assert_array_equal(a.targets, b.targets)
        for idx in (np.arange(7), np.arange(len(a))[::-1]):  # the train transform draws
            np.testing.assert_array_equal(a.gather(idx), b.gather(idx))


# -- the feature-bank cache --------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bank_cache_round_trips_across_packages(tmp_path, writer):
    from nwhead_tpu.data import FeatureBankCache as JCache
    from nwhead_tpu.nw.streaming import nw_streaming_log_probs as jax_streaming

    rng = np.random.default_rng(1)
    feats = rng.standard_normal((300, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 300).astype(np.int32)
    meta = rng.integers(0, 3, 300)
    tag = {"arch": "resnet10", "seed": "0"}
    (FeatureBankCache if writer == "port" else JCache)(str(tmp_path)).save(
        feats, labels, metadata=meta, tag=tag)
    reader = JCache if writer == "port" else FeatureBankCache
    cache = reader(str(tmp_path))
    assert cache.exists() and cache.load_tag() == tag
    emb, lbl, m = cache.load()
    for got, want in ((emb, feats), (lbl, labels), (m, meta)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    ours = nw_streaming_log_probs(torch.from_numpy(q),
                                  FeatureBankCache(str(tmp_path)).chunks(128), 5)
    theirs = jax_streaming(jnp.asarray(q), JCache(str(tmp_path)).chunks(128), 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)
    assert [len(c[0]) for c in FeatureBankCache(str(tmp_path)).chunks(128, mmap=False)] == [
        128, 128, 44]
    empty = FeatureBankCache(str(tmp_path / "none"))
    assert not empty.exists() and empty.load_tag() is None


EVAL_ARGV = ["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10", "--modes",
             "full", "random"]


def test_eval_bank_cache_restores_what_it_saved(tmp_path, capsys):
    cache = str(tmp_path / "bank")
    saved = eval_cli.main(EVAL_ARGV + ["--bank_cache", cache])
    assert "Saved bank to" in capsys.readouterr().out
    restored = eval_cli.main(EVAL_ARGV + ["--bank_cache", cache])
    assert "Loaded cached bank" in capsys.readouterr().out
    assert restored == saved
    emb, lbl, meta = FeatureBankCache(cache).load()
    assert emb.shape == (64, 512) and meta is None  # the JAX CLI saves no metadata
    for arch, flag in (("resnet10", "int8"), ("vit_s16", "bf16_fused")):
        with pytest.raises(SystemExit, match="--bank_cache cannot be combined"):
            eval_cli.main(EVAL_ARGV + ["--bank_cache", cache, "--arch", arch,
                                       "--featurizer_precision", flag])


SERVE_ARGV = ["--dataset", "synthetic", "--arch", "resnet10", "--batch_size", "8",
              "--latency_bench", "--bench_batches", "1"]


def test_serve_bank_cache_tag(tmp_path):
    """The port's server restores its own cache (the same bank as a fresh
    precompute) and refuses one with another tag: another seed, or the JAX
    server's cache for the same flags."""
    import serve as jax_serve_cli

    cache = str(tmp_path / "port")
    args = serve_cli.parse_args(SERVE_ARGV + ["--device", "cpu", "--bank_cache", cache])
    train_ds, val_ds = serve_cli.build_datasets(args)
    fresh = serve_cli.build_server(args, train_ds)
    restored = serve_cli.build_server(args, train_ds)
    assert not fresh.bank_restored and restored.bank_restored
    assert FeatureBankCache(cache).load_tag() == serve_cli.bank_tag(args)
    assert torch.equal(restored.full_feat, fresh.full_feat)
    x = val_ds.gather(np.arange(8))
    assert torch.equal(restored.make_serving_fn()(x), fresh.make_serving_fn()(x))
    other = serve_cli.parse_args(SERVE_ARGV + ["--device", "cpu", "--bank_cache", cache,
                                               "--seed", "1"])
    with pytest.raises(SystemExit, match="was built with"):
        serve_cli.build_server(other, train_ds)

    jax_cache = str(tmp_path / "jax")
    jax_args = argparse.Namespace(**{
        **vars(args), "bank_cache": jax_cache, "data_dir": "./", "ckpt": None, "proj_dim": 0,
        "platform": "cpu"})
    jax_serve_cli.build_server(jax_args)
    assert FeatureBankCache(jax_cache).load_tag().get("package") is None
    args.bank_cache = jax_cache
    with pytest.raises(SystemExit, match="was built with"):
        serve_cli.build_server(args, train_ds)
