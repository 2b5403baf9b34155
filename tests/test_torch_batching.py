"""The port's ``MicroBatcher`` (``nwhead_tpu_torch/utils/batching.py``):
the JAX package's ``tests/test_batching.py`` cases, the JAX batcher and the
port's over one numpy function (equal rows), a serving callable that
returns a tensor (read back by the collector thread), and single-image
submits through the port's ``NWNet.make_serving_fn`` on the CPU against
the direct batched call (atol 1e-6)."""

import threading
import time

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.utils.batching import MicroBatcher

torch.set_num_threads(1)


def _counting_serve(record):
    def serve(batch):
        record.append(np.asarray(batch).shape)
        return np.asarray(batch).sum(axis=tuple(range(1, batch.ndim))) * 2.0

    return serve


def test_results_match_direct_computation():
    calls = []
    with MicroBatcher(_counting_serve(calls), max_batch=8, max_wait_ms=5) as mb:
        futs = [mb.submit(np.full((4, 4), float(i))) for i in range(20)]
        got = [f.result(timeout=10) for f in futs]
    for i, g in enumerate(got):
        assert g == pytest.approx(i * 16 * 2.0)
    assert all(s == (8, 4, 4) for s in calls)  # every batch padded to one shape
    assert mb.dispatched_items == 20 and mb.dispatches == len(calls)


def test_full_batch_coalesces_into_one_call():
    calls = []
    mb = MicroBatcher(_counting_serve(calls), max_batch=8, max_wait_ms=200)
    futs = [mb.submit(np.ones((2,)) * i) for i in range(8)]
    [f.result(timeout=10) for f in futs]
    assert len(calls) == 1  # full: no wait for the latency bound
    mb.close()


def test_partial_batch_dispatches_after_max_wait():
    calls = []
    mb = MicroBatcher(_counting_serve(calls), max_batch=64, max_wait_ms=30)
    t0 = time.monotonic()
    f = mb.submit(np.ones((3,)))
    assert f.result(timeout=10) == pytest.approx(6.0)
    assert time.monotonic() - t0 >= 0.02
    assert calls and calls[0] == (64, 3)
    mb.close()


def test_concurrent_submitters():
    calls = []
    mb = MicroBatcher(_counting_serve(calls), max_batch=16, max_wait_ms=5)
    results = {}

    def client(i):
        results[i] = mb.submit(np.full((2, 2), float(i))).result(timeout=10)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(50)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    mb.close()
    assert not any(t.is_alive() for t in threads)
    for i in range(50):
        assert results[i] == pytest.approx(i * 4 * 2.0)
    assert mb.dispatched_items == 50


def test_error_propagates_to_callers():
    def boom(batch):
        raise RuntimeError("device on fire")

    mb = MicroBatcher(boom, max_batch=4, max_wait_ms=5)
    futs = [mb.submit(np.ones((2,))) for _ in range(3)]
    for f in futs:  # every caller of the batch gets the error
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
    mb.close()


def test_close_drains_then_rejects():
    calls = []
    mb = MicroBatcher(_counting_serve(calls), max_batch=8, max_wait_ms=500)
    futs = [mb.submit(np.ones((2,)) * i) for i in range(3)]
    mb.close()  # serves the partial batch without waiting 500 ms
    for i, f in enumerate(futs):
        assert f.result(timeout=1) == pytest.approx(i * 2 * 2.0)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.ones((2,)))


def test_rejects_an_empty_batch_size():
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(lambda b: b, max_batch=0)


def test_matches_the_jax_batcher_on_one_function():
    """The same items through both packages' batchers over one numpy
    function give equal rows (the padding rows never reach a caller)."""
    from nwhead_tpu.utils.batching import MicroBatcher as JaxMicroBatcher

    w = np.random.default_rng(0).standard_normal((12, 5)).astype(np.float32)

    def fn(batch):
        return np.tanh(batch.reshape(len(batch), -1) @ w)

    items = np.random.default_rng(1).standard_normal((13, 3, 4)).astype(np.float32)
    rows = {}
    for name, cls in (("port", MicroBatcher), ("jax", JaxMicroBatcher)):
        with cls(fn, max_batch=4, max_wait_ms=5) as mb:
            futs = [mb.submit(x) for x in items]
            rows[name] = np.stack([f.result(timeout=10) for f in futs])
    np.testing.assert_array_equal(rows["port"], rows["jax"])
    np.testing.assert_array_equal(rows["port"], fn(items))


def test_tensor_results_are_read_back():
    """A serving callable that returns a tensor: each caller gets a numpy
    row of it."""
    def serve(batch):
        return torch.as_tensor(batch) * 2.0 + 1.0

    with MicroBatcher(serve, max_batch=4, max_wait_ms=5) as mb:
        got = [mb.submit(np.full(3, float(i), np.float32)).result(timeout=10) for i in range(6)]
    for i, g in enumerate(got):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.full(3, 2.0 * i + 1.0, np.float32))


def test_microbatcher_over_the_port_serving_fn():
    """Single images submitted through the port's one-call serving callable
    give the rows of the direct batched call, padding and all."""
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.models import load_model
    from nwhead_tpu_torch.nw.net import NWNet

    ds = make_synthetic_dataset(n=32, n_classes=4, size=16, seed=0)
    net = NWNet(load_model("resnet10", device="cpu", generator=torch.Generator().manual_seed(0)),
                4, support_dataset=ds, device="cpu", fused_min_support=1)
    net.precompute()
    fn = net.make_serving_fn()
    x = ds.images[:6]
    want = fn(x).numpy()
    with MicroBatcher(fn, max_batch=6, max_wait_ms=20) as mb:
        futs = [mb.submit(x[i]) for i in range(6)]
        got = np.stack([f.result(timeout=30) for f in futs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with MicroBatcher(fn, max_batch=6, max_wait_ms=5) as mb:  # a padded batch of 2
        got = np.stack([mb.submit(x[i]).result(timeout=30) for i in range(2)])
    np.testing.assert_allclose(got, want[:2], rtol=0, atol=1e-6)
