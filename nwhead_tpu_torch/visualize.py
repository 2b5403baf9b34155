"""Explanation panels: the reference's similarity-ranking and
influence-ranking figures (``figs/*.png`` of the paper's repository, made
in notebooks) as one command over the serving stack of the port.

Port of ``scripts/visualize.py``. For each query image the panel shows the
query (predicted class and probability), its top-K support rows by
softmax weight (``nw.py:245-249``'s neighbours), the most helpful support
row and, where one exists, the most harmful one, by leave-one-out
influence on the predicted class (``util/metric.py:23-50``); the server
is ``serve.build_server``, the explanations ``serve._build_explainer``'s.
Each image is rescaled for display by ``utils.linear_normalization``.
matplotlib is imported only by ``main``. Run as::

    python -m nwhead_tpu_torch.visualize --dataset synthetic --arch resnet10 \\
        --out panels.png --n_queries 4 --topk 5 --device cpu
    # a trained model: --ckpt <run>/checkpoints/model.NNNN --dataset digits
"""

from __future__ import annotations

import argparse

import numpy as np

from nwhead_tpu_torch import serve
from nwhead_tpu_torch.utils import linear_normalization


def server_args(ns) -> argparse.Namespace:
    """The serve CLI's namespace for the panels' server: f32 featurizer
    and head, the full bank, a batch of the queries, PIL decoding."""
    argv = ["--dataset", ns.dataset, "--data_dir", ns.data_dir, "--arch", ns.arch,
            "--kernel_type", ns.kernel_type, "--n_shot_full", str(ns.n_shot_full),
            "--batch_size", str(max(1, ns.n_queries)), "--seed", str(ns.seed),
            "--workers", "1", "--decoder", "pil", "--device", ns.device]
    if ns.ckpt:
        argv += ["--ckpt", ns.ckpt]
    return serve.parse_args(argv)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="NW explanation panels (PyTorch port)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_dir", default="./")
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint of the port's training CLI (default: seeded weights)")
    p.add_argument("--kernel_type", default="euclidean")
    p.add_argument("--n_shot_full", type=int, default=100)
    p.add_argument("--n_queries", type=int, default=4)
    p.add_argument("--query_offset", type=int, default=0,
                   help="first index into the validation split")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--out", required=True, help="output PNG path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails without a GPU")
    ns = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    args = server_args(ns)
    train_ds, val_ds = serve.build_datasets(args)
    net = serve.build_server(args, train_ds, val_ds=val_ds)
    explain = serve._build_explainer(net, train_ds)

    qidx = np.arange(ns.query_offset, min(ns.query_offset + ns.n_queries, len(val_ds)))
    imgs = np.asarray(val_ds.gather(qidx))
    qy = np.asarray(val_ds.targets)[qidx]
    log_probs, expl = explain(imgs, ns.topk)
    bank_to_ds = np.concatenate(net.support_eval.full_bank_indices)

    def bank_img(row):
        return np.asarray(train_ds.gather(np.array([bank_to_ds[row]])))[0]

    def show(ax, img, title, color="black"):
        img = linear_normalization(np.asarray(img)[None])[0]
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.set_title(title, fontsize=7, color=color)
        ax.axis("off")

    n_rows, n_cols = len(qidx), 1 + ns.topk + 2  # query | neighbours | helpful | harmful
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(1.6 * n_cols, 1.8 * n_rows),
                             squeeze=False)
    for r, (e, lp) in enumerate(zip(expl, log_probs)):
        pred = e["predicted_class"]
        show(axes[r][0], imgs[r], f"query  true={qy[r]}\npred={pred} p={np.exp(lp[pred]):.2f}",
             color="green" if pred == qy[r] else "red")
        for c in range(ns.topk):
            ax = axes[r][1 + c]
            if c < len(e["neighbors"]):
                nb = e["neighbors"][c]
                show(ax, bank_img(nb["support_index"]),
                     f"nbr y={nb['label']}\nw={nb['weight']:.3f}")
            else:
                ax.axis("off")
        hcol = 1 + ns.topk
        if e["helpful"]:
            h = e["helpful"][0]
            show(axes[r][hcol], bank_img(h["support_index"]),
                 f"helpful y={h['label']}\ninfl={h['influence']:+.3f}", color="green")
        else:
            axes[r][hcol].axis("off")
        if "most_harmful" in e:
            h = e["most_harmful"]
            show(axes[r][hcol + 1], bank_img(h["support_index"]),
                 f"harmful y={h['label']}\ninfl={h['influence']:+.3f}", color="red")
        else:
            axes[r][hcol + 1].axis("off")
    fig.tight_layout()
    fig.savefig(ns.out, dpi=120)
    plt.close(fig)
    print(f"wrote {ns.out}: {n_rows} queries x (1+{ns.topk}+2) panels")
    return ns.out


if __name__ == "__main__":
    main()
