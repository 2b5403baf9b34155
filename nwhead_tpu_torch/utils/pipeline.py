"""Three-stage serving pipeline: host decode -> host-to-device copy ->
device compute, each stage overlapped with the others; and the JPEG
sources and stage rates of the serve CLI's ``--jpeg_bench``.

Port of the serving half of ``nwhead_tpu/utils/pipeline.py`` (the port's
``data/pipeline.py`` is the JAX package's ``data/pipeline.py``). Decode
runs on up to ``decode_depth`` threads (the C++ decode pool or PIL below
them), the copy on a thread of its own, and compute is launched on the
caller's thread, where CUDA runs it asynchronously: the steady rate
approaches the slowest stage rather than the sum of the three. The copy
is ``torch.as_tensor(x).to(device)`` from pageable memory; pinned staging
and copies on a side stream are ROADMAP.md item 13b. Every ``sync`` is a
host readback, which waits for the device.
"""

from __future__ import annotations

import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def three_stage_pipeline(
    n_batches: int,
    make_batch: Callable[[int], np.ndarray],
    to_device,
    compute,
    sync,
    decode_depth: int = 2,
) -> float:
    """Run ``n_batches`` through decode, copy and compute with the stages
    overlapped; returns the wall-clock seconds.

    ``make_batch(i)`` makes host batch ``i`` (on up to ``decode_depth``
    threads); ``to_device`` ships one host batch (one thread of its own);
    ``compute`` consumes a device batch on the caller's thread (its launch
    must be asynchronous); ``sync(out)`` waits for the last output.

    At most ``decode_depth + 2`` host batches and 2 device batches are in
    flight at a time, so memory does not grow with ``n_batches``; each
    stage needs one batch of lookahead to stay busy.
    """
    with ThreadPoolExecutor(max_workers=decode_depth) as dec_ex, \
            ThreadPoolExecutor(max_workers=1) as xfer_ex:
        t0 = time.perf_counter()
        dec_q: deque = deque()
        xfer_q: deque = deque()
        next_i = 0

        def pump():
            nonlocal next_i
            while next_i < n_batches and len(dec_q) + len(xfer_q) < decode_depth + 2:
                dec_q.append(dec_ex.submit(make_batch, next_i))
                next_i += 1
            while dec_q and len(xfer_q) < 2:
                f = dec_q.popleft()
                xfer_q.append(xfer_ex.submit(lambda f=f: to_device(f.result())))

        out = None
        for _ in range(n_batches):
            pump()
            dev = xfer_q.popleft().result()
            pump()  # refill while compute is launched
            out = compute(dev)
            del dev
        sync(out)
        return time.perf_counter() - t0


def synth_photo_jpegs(n: int, grid=(30, 40), block: int = 16, quality: int = 90,
                      seed: int = 0, prefix: str = "nw_jpeg_bench_",
                      dir: Optional[str] = None):
    """Write ``n`` synthetic photo-sized JPEGs (``grid`` x ``block``: 480 x
    640 by default, quality 90, the decoder benchmark's shape) of seeded
    colour blocks into a new directory under ``dir`` (the temporary
    directory by default). Returns the file paths."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = tempfile.mkdtemp(prefix=prefix, dir=dir)
    paths = []
    for i in range(n):
        img = np.kron(rng.integers(0, 255, (*grid, 3)), np.ones((block, block, 1))).astype(np.uint8)
        p = f"{d}/{i}.jpg"
        Image.fromarray(img).save(p, quality=quality)
        paths.append(p)
    return paths


def real_photo_jpegs(n: int, grid=(30, 40), block: int = 16, quality: int = 90,
                     prefix: str = "nw_jpeg_real_", dir: Optional[str] = None):
    """Write ``n`` JPEGs of real photographs at the benchmark's shape (480 x
    640 by default) from scikit-learn's two sample photos (``china.jpg``,
    ``flower.jpg``, 427 x 640, installed with sklearn). Block mosaics have
    long flat runs, which make Huffman decoding several times cheaper than
    on camera noise; these give the honest rate. Each file is rolled
    sideways by its own amount, so no cache can fold the set. Returns the
    paths, or None where sklearn does not import (then use
    ``synth_photo_jpegs``)."""
    try:
        from sklearn.datasets import load_sample_images
    except ImportError:
        return None
    from PIL import Image

    h, w = grid[0] * block, grid[1] * block
    photos = []
    for img in load_sample_images().images:
        img = np.asarray(img, np.uint8)
        # Tiled up to the canvas (427 rows wrap to 480), then cropped.
        reps = (h // img.shape[0] + 2, w // img.shape[1] + 2)
        photos.append(np.tile(img, (*reps, 1))[:h, :w])
    d = tempfile.mkdtemp(prefix=prefix, dir=dir)
    paths = []
    for i in range(n):
        img = np.roll(photos[i % len(photos)], 7 * (i // len(photos)), axis=1)
        p = f"{d}/{i}.jpg"
        Image.fromarray(img).save(p, quality=quality)
        paths.append(p)
    return paths


def photo_jpegs(n: int, seed: int = 0, prefix: str = "nw_jpeg_bench_",
                dir: Optional[str] = None):
    """The benchmark's JPEGs: ``(paths, "real")``, photographs, where
    sklearn is installed, else ``(paths, "synthetic")``, mosaics."""
    paths = real_photo_jpegs(n, prefix=prefix, dir=dir)
    if paths is not None:
        return paths, "real"
    return synth_photo_jpegs(n, seed=seed, prefix=prefix, dir=dir), "synthetic"


def jpeg_stage_rates(make_batch, serve, nb: int, bs: int, device, sync=None) -> dict:
    """Images in, answers out, by stage (one implementation for every
    caller, as JAX's serves its ``bench.py`` and serve CLI): host decode
    alone; the host-to-device copy alone (``measure_transfer_rate``); the
    device's wall clock per ``serve`` call on a batch already on
    ``device`` (launch included); and the pipelined rate through
    ``three_stage_pipeline``. ``sync(out)`` waits for ``out`` by a host
    readback (default: ``out.cpu()``). Returns images/s by stage, the
    copy's MB/s, the end-to-end queries/s and the slowest stage as
    ``bound_by``."""
    if sync is None:
        sync = lambda out: out.cpu()  # noqa: E731

    def to_device(x):
        return torch.as_tensor(x).to(device)

    sync(serve(to_device(make_batch(0))))  # warm the decode pool and the device

    t0 = time.perf_counter()
    for i in range(nb):
        make_batch(i)
    decode_rate = nb * bs / (time.perf_counter() - t0)

    # The device stage on a batch already there: copying it again would
    # charge the copy to this stage.
    imgs0 = make_batch(0)
    x0 = to_device(imgs0)
    out = None
    t0 = time.perf_counter()
    for _ in range(nb):
        out = serve(x0)
    sync(out)
    device_rate = nb * bs / (time.perf_counter() - t0)

    transfer_rate, transfer_mbps = measure_transfer_rate(
        imgs0, to_device, lambda x: x.reshape(-1)[0].item())

    dt = three_stage_pipeline(nb, make_batch, to_device, serve, sync)
    stages = {"host_decode": decode_rate, "transfer": transfer_rate, "device": device_rate}
    return {
        "decode_img_per_sec": round(decode_rate, 1),
        "transfer_img_per_sec": round(transfer_rate, 1),
        "transfer_mb_per_sec": round(transfer_mbps, 1),
        "device_wall_qps": round(device_rate, 1),
        "e2e_qps_from_jpeg": round(nb * bs / dt, 1),
        "bound_by": min(stages, key=stages.get),
    }


def measure_transfer_rate(imgs: np.ndarray, to_device, sync,
                          reps: int = 4) -> Tuple[float, float]:
    """The host-to-device rate of one batch shape: ``(images/s, MB/s)``.
    Each rep ships a buffer of its own (a copy with its first byte
    changed), so no runtime can serve a repeated copy from a cache;
    ``sync`` must wait for the copy (a readback). The first rep warms up
    and is not timed."""
    bufs = []
    for r in range(reps + 1):
        b = imgs.copy()
        b.flat[0] = (int(b.flat[0]) + r + 1) % 256
        bufs.append(b)
    sync(to_device(bufs[0]))
    t0 = time.perf_counter()
    for b in bufs[1:]:
        sync(to_device(b))
    dt = time.perf_counter() - t0
    return reps * imgs.shape[0] / dt, reps * imgs.nbytes / dt / 1e6
