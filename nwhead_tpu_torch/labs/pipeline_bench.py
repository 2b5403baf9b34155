"""Host decode benchmark: the ``pil``, ``native`` and ``native_fused``
decoders on photo-sized JPEGs, each at 8, 16 and 32 workers.

Port of ``scripts/pipeline_bench.py``. The host's decode rate bounds
image-file training and serving long before the device does. The JPEGs
(480 x 640, quality 90) are written for the run and removed afterwards:
real photographs (scikit-learn's two sample photos) where sklearn is
installed, synthetic colour blocks otherwise or with ``--synth``. Block
mosaics have flat runs that make Huffman decoding several times cheaper
than on camera images, so the source is printed first. Each decoder
gathers the batch through the imagenet training transform (crop, flip,
resize to 224, normalize). ``native`` and ``native_fused`` need libjpeg
(``native/decode.py`` builds the pool) and raise without it. Run as::

    python -m nwhead_tpu_torch.labs.pipeline_bench [--synth]
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from nwhead_tpu_torch.data import transforms as T
from nwhead_tpu_torch.data.datasets import ImageFileDataset
from nwhead_tpu_torch.utils.pipeline import real_photo_jpegs, synth_photo_jpegs

DECODERS = ("pil", "native", "native_fused")
WORKERS = (8, 16, 32)


def time_decoder(paths, decoder: str, workers: int, reps: int = 6) -> dict:
    """One decoder at one worker count: ``len(paths)`` images gathered
    through the training transform ``reps`` times after a warm-up gather
    of two (pools started, the native library built). Returns the host
    milliseconds a batch and images/s."""
    ds = ImageFileDataset(paths, np.zeros(len(paths), np.int64), 1,
                          transform=T.imagenet_train_transform(seed=0),
                          workers=workers, decoder=decoder)
    ds.gather([0, 1])
    idx = np.arange(len(paths))
    t0 = time.perf_counter()
    for _ in range(reps):
        ds.gather(idx)
    dt = (time.perf_counter() - t0) / reps
    return {"decoder": decoder, "workers": workers, "batch": len(paths),
            "ms_per_batch": dt * 1e3, "img_per_sec": len(paths) / dt}


def main(argv=None, n: int = 64, hw=(480, 640)) -> list:
    p = argparse.ArgumentParser(description="JPEG decoder benchmark (PIL vs the libjpeg pool)")
    p.add_argument("--synth", action="store_true",
                   help="synthetic colour-block JPEGs instead of photographs")
    args = p.parse_args(argv)
    grid = (hw[0] // 16, hw[1] // 16)
    results = []
    with tempfile.TemporaryDirectory(prefix="nw_pipeline_bench_") as tmp:
        paths, source = None, "synthetic"
        if not args.synth:
            paths, source = real_photo_jpegs(n, grid=grid, dir=tmp), "real"
        if paths is None:
            paths, source = synth_photo_jpegs(n, grid=grid, dir=tmp), "synthetic"
        print(f"jpeg source: {source}", flush=True)
        for dec in DECODERS:
            for w in WORKERS:
                r = time_decoder(paths, dec, w)
                print(f"{dec:13s} workers={w:3d}: {r['ms_per_batch']:7.1f} ms/batch{n} "
                      f"({r['img_per_sec']:,.0f} img/s)", flush=True)
                results.append(r)
    return results


if __name__ == "__main__":
    main()
