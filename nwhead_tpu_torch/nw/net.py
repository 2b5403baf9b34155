"""NWNet: featurizer + NW head, episodic training forward, and inference.

Port of ``nwhead_tpu/nw/net.py``. ``NWModel`` holds the weights (featurizer,
optional projection, head) as an ``nn.Module``; its ``forward`` is the
episodic training forward, query and support in one featurizer batch so
that BatchNorm sees both and gradients reach the support features.
``NWNet`` is the host-side orchestrator: it samples training episodes
(``support_train``, ``forward``), builds the full-mode support bank
(``precompute``), prepares it for the fused head when it is large enough
(f32/bf16: K2; ``head_precision`` int8/int4: K4/K5), and predicts in the
``random`` and ``full`` modes (``predict``, ``make_serving_fn``).
``fuse_featurizer`` swaps the eval and serving featurizer of a ViT for the
bf16 fused-serving graph (K10/K11), ``quantize_featurizer`` for the int8
one (K10/K11 int8). The cluster, ensemble, knn and hnsw modes,
incremental bank edits and sharding are later slices (ROADMAP.md queue 1,
items 7, 8 and 10).

Numerics: on a CUDA device ``NWNet`` turns TF32 off for the process
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), for the backward convolutions
too. cuDNN runs f32 convolutions in TF32 by default, about three decimal
digits, which would break parity with the f32 JAX featurizer.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from nwhead_tpu_torch.nw.head import NWHead
from nwhead_tpu_torch.nw.support import SupportSetEval, SupportSetTrain
from nwhead_tpu_torch.ops.fused_nw import PreparedSupport, prepare_support
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES


class NWModel(nn.Module):
    """Featurizer (+ optional ``proj_dim`` linear projection) + NW head."""

    def __init__(self, featurizer: nn.Module, n_classes: int,
                 kernel_type: str = "euclidean", head_precision: str = "f32", *,
                 proj_dim: int = 0, feat_dim: Optional[int] = None, use_fused: bool = True,
                 fused_min_support: int = 1024,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.featurizer = featurizer
        self.proj = None
        if proj_dim > 0:
            if feat_dim is None:
                raise ValueError("proj_dim needs feat_dim, the featurizer's output width")
            # torch's nn.Linear init, drawn from `generator`.
            self.proj = nn.Linear(feat_dim, proj_dim)
            with torch.no_grad():
                nn.init.kaiming_uniform_(self.proj.weight, a=math.sqrt(5), generator=generator)
                bound = 1.0 / math.sqrt(feat_dim)
                self.proj.bias.uniform_(-bound, bound, generator=generator)
        self.head = NWHead(n_classes, kernel_type, head_precision, use_fused, fused_min_support)

    def featurize(self, x: torch.Tensor) -> torch.Tensor:
        f = self.featurizer(x)
        return f if self.proj is None else self.proj(f)

    def forward(self, qx: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
        """Episodic training forward: one featurizer batch of query and
        support, then the head. ``sx`` is shared ``(S, H, W, C)`` or
        per-query ``(B, S, H, W, C)``."""
        batch = qx.shape[0]
        per_query = sx.dim() == qx.dim() + 1
        sx_flat = sx.reshape(-1, *sx.shape[-3:]) if per_query else sx
        feats = self.featurize(torch.cat([qx, sx_flat]))
        qfeat, sfeat = feats[:batch], feats[batch:]
        if per_query:
            sfeat = sfeat.reshape(batch, sx.shape[1], -1)
        return self.head(qfeat, sfeat, sy)

    def predict_from_prepared(self, qfeat: torch.Tensor, prepared: PreparedSupport) -> torch.Tensor:
        return self.head.from_prepared(qfeat, prepared)


class NWNet:
    """Training and inference orchestrator.

    :param featurizer: a backbone from ``nwhead_tpu_torch.models.load_model``.
    :param n_classes: number of classes.
    :param support_dataset: object with ``.targets`` and ``gather(indices) ->
        (n, H, W, C) float images``.
    :param device: where the weights, the bank and the computation live.

    The other parameters are the JAX package's. The full bank is prepared
    for the fused head (K2) when ``use_fused`` and it holds at least
    ``fused_min_support`` rows; otherwise full mode runs the head over the
    raw bank features. ``seed`` seeds the episodic samplers (as in the JAX
    package) and the projection's init.
    """

    def __init__(
        self,
        featurizer: nn.Module,
        n_classes: int,
        support_dataset=None,
        *,
        device: Union[str, torch.device],
        feat_dim: Optional[int] = None,
        proj_dim: int = 0,
        kernel_type: str = "euclidean",
        train_type: str = "random",
        n_way: Optional[int] = None,
        n_shot: int = 1,
        n_shot_random: int = 1,
        n_shot_full: int = 100,
        env_array: Optional[Sequence[int]] = None,
        debug_mode: bool = False,
        use_fused: bool = True,
        fused_min_support: int = 1024,
        head_precision: str = "f32",
        seed: int = 0,
        precompute_batch: int = 128,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' was asked for, but no CUDA device is visible")
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.n_classes = n_classes
        self.kernel_type = kernel_type
        self.debug_mode = debug_mode
        self.support_dataset = support_dataset
        self.precompute_batch = precompute_batch
        self.model = NWModel(
            featurizer, n_classes, kernel_type, head_precision, proj_dim=proj_dim,
            feat_dim=feat_dim, use_fused=use_fused, fused_min_support=fused_min_support,
            generator=torch.Generator().manual_seed(seed),
        )
        self.model.to(self.device).eval()
        if support_dataset is not None:
            targets = np.asarray(support_dataset.targets)
            self.support_train = SupportSetTrain(
                targets, n_classes, train_type, n_shot, n_way=n_way, env_array=env_array,
                seed=seed,
            )
            self.support_eval = SupportSetEval(
                targets, n_classes, n_shot_random, n_shot_full, env_array=env_array,
                seed=seed,
            )
        self._prepared_full: Optional[PreparedSupport] = None
        self._prepared_pos: Optional[np.ndarray] = None  # bank row -> prepared row
        # Eval/serving featurizer set by fuse_featurizer or quantize_featurizer
        # (None: the model's).
        self.serving_featurizer: Optional[nn.Module] = None

    # -- training forward ------------------------------------------------------

    def forward(self, x, y, support_data=None):
        """Episodic training forward in train mode (BatchNorm on batch
        statistics, running statistics updated): ``(log_probs, isin)``,
        ``isin[i]`` whether query i's class is in the episode. The episode
        comes from ``support_train`` unless ``support_data=(sx, sy, meta)``
        gives it."""
        if support_data is not None:
            sx, sy, _ = support_data
        else:
            idx, sy, _ = self.support_train.get_support(np.asarray(y))
            sx = self.support_dataset.gather(idx)
        isin = np.isin(np.asarray(y), np.asarray(sy))
        if self.debug_mode:
            print("qx shape:", tuple(x.shape))
            print("sx shape:", tuple(sx.shape))
            print("qy:", np.asarray(y))
            print("sy:", np.asarray(sy))
            print("qy in sy:", isin)
            print(f"Percent query dropped: {(1.0 - isin.mean()) * 100}%")
        self.model.train()
        log_probs = self.model(
            torch.as_tensor(x).to(self.device), torch.as_tensor(sx).to(self.device),
            torch.as_tensor(np.asarray(sy), dtype=torch.int64, device=self.device),
        )
        return log_probs, isin

    # -- serving featurizer ----------------------------------------------------

    def fuse_featurizer(self) -> None:
        """Swap the eval and serving featurizer for the bf16 fused-serving
        graph (``models/serving_vit.py``: K10 and K11 per block) built from
        the current weights, with no calibration. ``proj`` still applies.
        Training (``forward``) keeps the float featurizer. The prepared bank
        is dropped: run ``precompute`` after this, so that the bank and the
        queries come from the same featurizer. ViT only; serving only."""
        from nwhead_tpu_torch.models.serving_vit import fuse_vit_serving
        from nwhead_tpu_torch.models.vit import VisionTransformer

        if not isinstance(self.model.featurizer, VisionTransformer):
            raise NotImplementedError(
                "fuse_featurizer is the ViT bf16 fused-serving path; a "
                f"{type(self.model.featurizer).__name__} backbone has none (its int8 "
                "PTQ through quantize_featurizer is not ported yet: ROADMAP.md queue 1, "
                "item 9)")
        self.serving_featurizer = fuse_vit_serving(self.model.featurizer)
        self._prepared_full = self._prepared_pos = None

    def quantize_featurizer(self, calib_images, calib_batch: int = 64) -> None:
        """Swap the eval and serving featurizer for the int8 post-training-
        quantized one (``models/quantize.py``: K10 int8 and K11 int8 per ViT
        block), its activation scales calibrated on ``calib_images`` (NHWC,
        post-transform) from the current weights. ``proj`` still applies.
        Training (``forward``) keeps the float featurizer. The prepared bank
        is dropped: run ``precompute`` after this, so that the bank is built
        from the same quantized features as the queries. ViTs only so far
        (a ResNet raises); serving only."""
        from nwhead_tpu_torch.models.quantize import quantize_featurizer

        self.serving_featurizer = quantize_featurizer(self.model.featurizer, calib_images,
                                                      calib_batch)
        self._prepared_full = self._prepared_pos = None

    def _featurize_eval(self, x: torch.Tensor) -> torch.Tensor:
        """Features of the eval and serving paths: the fused or quantized
        serving featurizer when there is one (then ``proj``), else the
        model's."""
        if self.serving_featurizer is None:
            return self.model.featurize(x)
        f = self.serving_featurizer(x)
        return f if self.model.proj is None else self.model.proj(f)

    # -- precompute ------------------------------------------------------------

    @torch.inference_mode()
    def precompute(self) -> None:
        """Featurize the full support bank (device-resident, eval mode) and
        prepare it for the fused head when it is large enough."""
        self.model.eval()
        feats, ys = [], []
        envs = self.support_eval.envs
        for bank_idx in self.support_eval.full_bank_indices:
            feats.append(self._featurize_bank(bank_idx))
            ys.append(envs.targets[bank_idx])
        self.support_eval.build_infer_iters(torch.cat(feats), np.concatenate(ys))
        self._build_serving_banks()

    def _featurize_bank(self, bank_idx: np.ndarray) -> torch.Tensor:
        """Featurizer pass over the bank in batches of ``precompute_batch``
        images gathered one batch at a time; the last batch is zero-padded
        to the same shape and its padding rows dropped."""
        bs = self.precompute_batch
        out = []
        for start in range(0, len(bank_idx), bs):
            imgs = np.asarray(self.support_dataset.gather(bank_idx[start:start + bs]), np.float32)
            n = len(imgs)
            if n < bs:
                imgs = np.concatenate([imgs, np.zeros((bs - n, *imgs.shape[1:]), np.float32)])
            x = torch.from_numpy(imgs).to(self.device)
            out.append(self._featurize_eval(x)[:n])
        return torch.cat(out)

    def _build_serving_banks(self) -> None:
        """Prepare the full bank for the fused head when ``use_fused`` and it
        holds at least ``fused_min_support`` rows, and map each bank row to
        its prepared row (``prepare_support`` may sort rows by class)."""
        self.full_feat = self.support_eval.full_feat
        self.full_y = self.support_eval.full_y
        self._prepared_full = self._prepared_pos = None
        head = self.model.head
        S = len(self.full_y)
        if not (head.use_fused and S >= head.fused_min_support
                and self.kernel_type in KERNEL_NAMES):
            return
        self._prepared_full, order = prepare_support(
            self.full_feat, self.full_y, self.n_classes,
            kernel=self.kernel_type, precision=head.precision, return_order=True,
        )
        if order is None:
            self._prepared_pos = np.arange(S, dtype=np.int64)
        else:
            inv = np.empty(S, np.int64)
            inv[order] = np.arange(S, dtype=np.int64)
            self._prepared_pos = inv

    # -- inference -------------------------------------------------------------

    def make_serving_fn(self, normalize=None, mode: str = "full"):
        """The per-request callable of the prepared full-mode path:
        ``(B, H, W, C) images -> (B, n_classes) log-probs`` composing
        normalize -> featurize -> prepared head. Accepts numpy arrays or
        tensors on any device and returns a tensor on ``self.device``.
        ``normalize=(mean, std)`` applies ``(x/255 - mean)/std`` first (for
        uint8 pixels). The bank is read at call time, so a later
        ``precompute`` reaches existing serving callables."""
        if mode == "ivf":
            raise NotImplementedError("mode 'ivf' is not ported yet (ROADMAP.md queue 1, item 8)")
        if mode != "full":
            raise ValueError(f"make_serving_fn serves mode 'full', got {mode!r}")
        if self._prepared_full is None:
            raise ValueError("make_serving_fn needs the prepared full-mode bank: run "
                             "precompute() with use_fused and at least fused_min_support rows")
        mean = std = None
        if normalize is not None:
            mean = torch.as_tensor(normalize[0], dtype=torch.float32, device=self.device)
            std = torch.as_tensor(normalize[1], dtype=torch.float32, device=self.device)
        model, device = self.model, self.device

        @torch.inference_mode()
        def serve(x) -> torch.Tensor:
            model.eval()
            x = torch.as_tensor(x).to(device)
            if mean is not None:
                x = (x.to(torch.float32) * (1.0 / 255.0) - mean) / std
            return model.predict_from_prepared(self._featurize_eval(x), self._prepared_full)

        return serve

    @torch.inference_mode()
    def predict(self, x, mode: str = "random") -> torch.Tensor:
        """Log-probs for a batch of images, in eval mode. ``random``: the
        head over an episode drawn from the bank; ``full``: the prepared
        bank (K2, K4 or K5) when there is one, else the head over the whole
        bank."""
        self.model.eval()
        support = self.support_eval.get_support(mode)  # raises for modes not ported
        qfeat = self._featurize_eval(torch.as_tensor(x).to(self.device))
        if mode == "full" and self._prepared_full is not None:
            return self.model.predict_from_prepared(qfeat, self._prepared_full)
        return self.model.head(qfeat, *support)
