"""The port's HTTP daemon (``nwhead_tpu_torch/utils/httpd.py``, the serve
CLI's ``build_http_server``) against the JAX package's
(``nwhead_tpu/utils/httpd.py`` over the root ``serve.py``'s server) on the
same weights, over real sockets.

Both servers run on CIFAR-10-shaped ``.npy`` files (64 / 32 images, 10
classes) with ResNet-10, a 50-row bank (``--n_shot_full 5``) and batches of
8; the JAX net's variables are carried to the port by
``models/convert.py``. The same ``/predict`` payloads (JSON ``inputs``,
``images_b64`` JPEGs, a raw JPEG body) give the same labels with
probabilities within 1e-4 (``TOL``); after one add and one remove the
bank rows and the predictions still agree; the 400 / 404 error surface is
JAX's. A concurrency test predicts from 4 threads through 10 live edits,
each bank build slowed so that requests land inside it: every response is
a 200.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = 1e-4
N_TRAIN, N_TEST, C = 64, 32, 10


def _post(url, obj=None, body=None, ctype="application/json"):
    data = body if body is not None else json.dumps(obj or {}).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    return 200, ""


def _jpeg(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _write_cifar10(root) -> None:
    rng = np.random.default_rng(7)
    base = root / "cifar10"
    base.mkdir()
    for split, n in (("train", N_TRAIN), ("test", N_TEST)):
        np.save(base / f"{split}_images.npy", rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        np.save(base / f"{split}_labels.npy", np.arange(n) % C)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX server, port server, the raw test images): both started, both
    nets on the same weights and the same 50-row bank."""
    import argparse

    import serve as jserve
    from nwhead_tpu.data import transforms as JT
    from nwhead_tpu.utils.batching import MicroBatcher as JaxMicroBatcher
    from nwhead_tpu.utils.httpd import NWHttpServer as JaxHttpServer
    from nwhead_tpu_torch import serve as pserve
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel

    root = tmp_path_factory.mktemp("cifar")
    _write_cifar10(root)
    jargs = argparse.Namespace(
        dataset="cifar10", data_dir=str(root), arch="resnet10", ckpt=None,
        pretrained_path=None, batch_size=8, kernel_type="euclidean", proj_dim=0,
        n_shot_full=5, bf16=False, head_precision="f32", featurizer_precision="f32",
        calib_images=16, fused_inference=False, workers=1, decoder="pil", seed=0,
        bank_cache=None, mesh=None, serve_mode="full", ivf_probe=32, ivf_group=None)
    jnet, variables, _, _ = jserve.build_server(jargs)

    def jdecode(t):
        from PIL import Image

        return lambda b: t(np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))

    # JAX serve.py:440-478 for a CIFAR dataset (http_serve blocks, so built here).
    jsrv = JaxHttpServer(jnet, variables, None, input_shape=(32, 32, 3),
                         decode_query=jdecode(JT.cifar_eval_transform()),
                         decode_support=jdecode(JT.cifar_eval_transform()), topk=3)
    jsrv.batcher = JaxMicroBatcher(jserve.serving_fn(jnet, variables), max_batch=8,
                                   max_wait_ms=5.0)

    pargs = pserve.parse_args([
        "--dataset", "cifar10", "--data_dir", str(root), "--arch", "resnet10",
        "--batch_size", "8", "--n_shot_full", "5", "--topk", "3", "--http", "0",
        "--decoder", "pil", "--workers", "1", "--device", "cpu"])
    ptrain, pval = pserve.build_datasets(pargs)
    state = jax_to_torch_nwmodel(variables)

    def same_weights(net):
        net.model.load_state_dict(state)

    pnet = pserve.build_server(pargs, ptrain, edit=same_weights, val_ds=pval)
    psrv = pserve.build_http_server(pnet, ptrain, pval, pargs)
    raw = np.load(root / "cifar10" / "test_images.npy")
    jsrv.start()
    psrv.start()
    try:
        yield jsrv, psrv, raw
    finally:
        for srv in (jsrv, psrv):
            srv.shutdown()
            srv.batcher.close()


def _urls(servers):
    jsrv, psrv, _ = servers
    return f"http://127.0.0.1:{jsrv.port}", f"http://127.0.0.1:{psrv.port}"


def _agree(jpreds, ppreds):
    assert len(jpreds) == len(ppreds)
    for j, p in zip(jpreds, ppreds):
        assert p["label"] == j["label"]
        assert [t["class"] for t in p["topk"]] == [t["class"] for t in j["topk"]]
        np.testing.assert_allclose([t["prob"] for t in p["topk"]],
                                   [t["prob"] for t in j["topk"]], rtol=0, atol=TOL)


def _normalized(raw):
    from nwhead_tpu_torch.data import transforms as T

    t = T.cifar_eval_transform()
    return np.stack([t(img) for img in raw])


def test_healthz_matches_jax(servers):
    jurl, purl = _urls(servers)
    j, p = _get(f"{jurl}/healthz"), _get(f"{purl}/healthz")
    assert p == j == {"ok": True, "bank_rows": 50, "n_classes": C, "head_precision": "f32"}


def test_predict_payloads_match_jax(servers):
    """JSON inputs, base64 JPEGs and a raw JPEG body: the same labels, top-k
    classes and probabilities within 1e-4."""
    jurl, purl = _urls(servers)
    _, _, raw = servers
    body = {"inputs": _normalized(raw[:4]).tolist(), "topk": 4}
    _agree(_post(f"{jurl}/predict", body)["predictions"],
           _post(f"{purl}/predict", body)["predictions"])
    b64 = {"images_b64": [base64.b64encode(_jpeg(img)).decode() for img in raw[4:9]]}
    ppreds = _post(f"{purl}/predict", b64)["predictions"]
    assert len(ppreds) == 5 and all(len(p["topk"]) == 3 for p in ppreds)
    _agree(_post(f"{jurl}/predict", b64)["predictions"], ppreds)
    one = _jpeg(raw[9])
    _agree(_post(f"{jurl}/predict", body=one, ctype="image/jpeg")["predictions"],
           _post(f"{purl}/predict", body=one, ctype="image/jpeg")["predictions"])


def test_add_and_remove_support_match_jax(servers):
    """One add of 3 JPEGs and one remove of those rows: the same bank rows
    after each, and the same predictions on the edited banks."""
    jurl, purl = _urls(servers)
    _, _, raw = servers
    q = {"inputs": _normalized(raw[10:13]).tolist()}
    add = {"images_b64": [base64.b64encode(_jpeg(img)).decode() for img in raw[13:16]],
           "labels": [1, 2, 3]}
    before = _get(f"{purl}/healthz")["bank_rows"]
    for url in (jurl, purl):
        out = _post(f"{url}/add_support", add)
        assert out == {"ok": True, "bank_rows": before + 3}
    _agree(_post(f"{jurl}/predict", q)["predictions"], _post(f"{purl}/predict", q)["predictions"])
    rows = {"rows": [before, before + 1, before + 2]}  # the tail of the one environment
    for url in (jurl, purl):
        assert _post(f"{url}/remove_support", rows) == {"ok": True, "bank_rows": before}
    _agree(_post(f"{jurl}/predict", q)["predictions"], _post(f"{purl}/predict", q)["predictions"])


def test_error_surface_matches_jax(servers):
    """The same bad requests give the same status codes on both servers."""
    jurl, purl = _urls(servers)
    cases = [
        ("POST", "/predict", {"nothing": 1}, None, "application/json"),
        ("POST", "/predict", {"inputs": [[1.0, 2.0]]}, None, "application/json"),
        ("POST", "/predict", None, b"not json", "application/json"),
        ("POST", "/predict", None, b"\xff\xd8notajpeg", "image/jpeg"),
        ("POST", "/add_support", {"inputs": [[1.0]]}, None, "application/json"),
        ("POST", "/add_support", {"labels": [0]}, None, "application/json"),
        ("POST", "/add_support", {"inputs": _normalized(np.zeros((2, 32, 32, 3), np.uint8))
                                  .tolist(), "labels": [0]}, None, "application/json"),
        ("POST", "/remove_support", {}, None, "application/json"),
        ("POST", "/nope", {}, None, "application/json"),
        ("GET", "/nope", None, None, None),
    ]
    got = []
    for method, path, obj, body, ctype in cases:
        codes = []
        for url in (jurl, purl):
            if method == "GET":
                codes.append(_status(lambda: _get(url + path))[0])
            else:
                codes.append(_status(lambda: _post(url + path, obj, body, ctype))[0])
        assert codes[1] == codes[0], (path, obj, body, codes)
        got.append(codes[1])
    # A body PIL cannot decode is a 500 in both (an OSError, not a ValueError).
    assert got == [400, 400, 400, 500, 400, 400, 400, 400, 404, 404]
    assert "shape" in _status(lambda: _post(f"{purl}/predict", {"inputs": [[1.0, 2.0]]}))[1]
    stats = _get(f"{purl}/stats")
    assert stats["errors"] >= 8 and stats["device_batches"] >= 1
    assert {"requests", "items", "support_edits", "latency_ms",
            "mean_batch_occupancy"} <= set(stats)


def test_predictions_never_fail_during_live_edits(servers):
    """4 threads predict without pause while 10 edits (5 adds of 4 images,
    each followed by the removal of those rows; some removals compact the
    bank) run on another thread. Every bank build is slowed by 20 ms, so
    requests arrive while the new bank is being built: each must be served
    from the old bank or the new one (a 200 with finite probabilities),
    never fail."""
    from nwhead_tpu_torch.nw import net as net_mod

    _, purl = _urls(servers)
    _, psrv, raw = servers
    q = {"inputs": _normalized(raw[16:18]).tolist()}
    add = {"images_b64": [base64.b64encode(_jpeg(img)).decode() for img in raw[18:22]],
           "labels": [0, 1, 2, 3]}

    def slowed(fn):
        def f(*a, **kw):
            out = fn(*a, **kw)
            time.sleep(0.02)
            return out
        return f

    stop = threading.Event()
    codes, bad = [], []

    def client():
        while not stop.is_set():
            code, err = _status(lambda: codes.append(_post(f"{purl}/predict", q)))
            if code != 200:
                bad.append((code, err))

    with mock.patch.object(net_mod, "prepare_support", slowed(net_mod.prepare_support)), \
            mock.patch.object(net_mod, "concat_prepared", slowed(net_mod.concat_prepared)), \
            mock.patch.object(net_mod, "mask_prepared_rows", slowed(net_mod.mask_prepared_rows)):
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(5):
                n = _post(f"{purl}/add_support", add)["bank_rows"]
                assert _post(f"{purl}/remove_support",
                             {"rows": list(range(n - 4, n))})["bank_rows"] == n - 4
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert len(codes) >= 4
    for out in codes:
        probs = [t["prob"] for p in out["predictions"] for t in p["topk"]]
        assert len(out["predictions"]) == 2 and np.isfinite(probs).all()
    assert psrv.stats.edits >= 10
