"""The port's serving pipeline (``nwhead_tpu_torch/utils/pipeline.py``) and
decoder benchmark (``nwhead_tpu_torch/labs/pipeline_bench.py``): the JAX
package's ``tests/test_pipeline_util.py`` cases (the three stages overlap,
each on its own thread, order kept; the copy rate ships distinct buffers),
``synth_photo_jpegs`` decoding to the JAX package's pixels for one seed,
``jpeg_stage_rates`` on a CPU tensor stage, and the benchmark's timing
function and CLI at a small size."""

import threading
import time

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.utils import linear_normalization
from nwhead_tpu_torch.utils.pipeline import (
    jpeg_stage_rates,
    measure_transfer_rate,
    photo_jpegs,
    synth_photo_jpegs,
    three_stage_pipeline,
)

torch.set_num_threads(1)


def test_overlap_beats_serial():
    """Decode, copy and compute each sleep d a batch: serial costs 3 n d,
    the pipeline about (n + 2) d; it must land well under 2 n d."""
    d, n = 0.03, 8

    def make_batch(i):
        time.sleep(d)
        return np.full((4,), i, np.int32)

    def to_device(b):
        time.sleep(d)
        return b

    outs = []

    def compute(b):
        time.sleep(d)
        outs.append(int(b[0]))
        return b

    dt = three_stage_pipeline(n, make_batch, to_device, compute, sync=lambda o: o)
    assert outs == list(range(n)), "batch order must be kept"
    assert dt < 2 * n * d, f"no overlap: {dt:.3f}s vs serial {3 * n * d:.3f}s"


def test_stages_run_on_distinct_threads():
    seen = {"decode": set(), "xfer": set(), "compute": set()}

    def make_batch(i):
        seen["decode"].add(threading.get_ident())
        return np.zeros((2,), np.float32)

    def to_device(b):
        seen["xfer"].add(threading.get_ident())
        return b

    def compute(b):
        seen["compute"].add(threading.get_ident())
        return b

    three_stage_pipeline(4, make_batch, to_device, compute, sync=lambda o: o)
    main = threading.get_ident()
    assert main not in seen["decode"] and main not in seen["xfer"]
    assert seen["compute"] == {main}
    assert len(seen["xfer"]) == 1


def test_transfer_rate_distinct_buffers():
    shipped = []

    def to_device(b):
        shipped.append(b.flat[0])
        time.sleep(0.01)
        return b

    imgs = np.zeros((8, 4, 4, 3), np.uint8)
    img_rate, mbps = measure_transfer_rate(imgs, to_device, sync=lambda o: o, reps=3)
    assert len(shipped) == 4 and len(set(shipped)) == 4  # a warm-up and 3 distinct reps
    assert img_rate > 0 and mbps > 0
    assert img_rate <= 24 / 0.03


def test_synth_photo_jpegs_decode_to_jaxs_pixels(tmp_path, monkeypatch):
    """One seed: the port's files decode to the JAX package's pixels."""
    import tempfile

    from PIL import Image

    from nwhead_tpu.utils.pipeline import synth_photo_jpegs as jax_synth

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # JAX's files land here too
    got = synth_photo_jpegs(3, grid=(6, 8), seed=5, dir=str(tmp_path))
    want = jax_synth(3, grid=(6, 8), seed=5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.startswith(str(tmp_path))
        a, b = np.asarray(Image.open(g)), np.asarray(Image.open(w))
        assert a.shape == (96, 128, 3)
        np.testing.assert_array_equal(a, b)


def test_photo_jpegs_names_its_source(tmp_path):
    pytest.importorskip("sklearn")
    paths, source = photo_jpegs(2, dir=str(tmp_path))
    assert source == "real" and len(paths) == 2
    from PIL import Image

    assert np.asarray(Image.open(paths[0])).shape == (480, 640, 3)


def test_jpeg_stage_rates_on_the_cpu(tmp_path):
    """The four rates and the binding stage, through a tensor stage that
    returns a tensor (the readback is ``.cpu()``)."""
    paths = synth_photo_jpegs(4, grid=(4, 4), dir=str(tmp_path))
    from PIL import Image

    def make_batch(i):
        return np.stack([np.asarray(Image.open(p)) for p in paths])

    def serve(x):
        return x.to(torch.float32).mean(dim=(1, 2))

    rates = jpeg_stage_rates(make_batch, serve, nb=2, bs=4, device=torch.device("cpu"))
    assert set(rates) == {"decode_img_per_sec", "transfer_img_per_sec", "transfer_mb_per_sec",
                          "device_wall_qps", "e2e_qps_from_jpeg", "bound_by"}
    assert all(v > 0 for k, v in rates.items() if k != "bound_by")
    assert rates["bound_by"] in ("host_decode", "transfer", "device")


def test_linear_normalization_matches_jax():
    from nwhead_tpu.utils import linear_normalization as jax_ln

    x = np.random.default_rng(0).standard_normal((2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(linear_normalization(x), np.asarray(jax_ln(x)), rtol=1e-6)


def test_pipeline_bench_times_each_decoder(monkeypatch, tmp_path, capsys):
    from nwhead_tpu_torch.labs import pipeline_bench as pb

    paths = synth_photo_jpegs(4, grid=(8, 8), dir=str(tmp_path))
    r = pb.time_decoder(paths, "pil", 2, reps=1)
    assert r["decoder"] == "pil" and r["workers"] == 2 and r["batch"] == 4
    assert r["ms_per_batch"] > 0 and r["img_per_sec"] > 0
    monkeypatch.setattr(pb, "WORKERS", (2,))
    out = pb.main(["--synth"], n=4)
    assert [(x["decoder"], x["workers"]) for x in out] == [(d, 2) for d in pb.DECODERS]
    assert capsys.readouterr().out.startswith("jpeg source: synthetic")
