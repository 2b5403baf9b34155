"""NWNet: featurizer + NW head, and the host-side serving orchestration.

Port of the serving half of ``nwhead_tpu/nw/net.py``. ``NWModel`` holds the
weights (featurizer and head, an ``nn.Module``); ``NWNet`` builds the
full-mode support bank (``precompute``), prepares it for the fused head
(``_build_serving_banks``) and serves from it (``make_serving_fn``,
``predict``). The episodic training forward, the other inference modes,
incremental bank edits and sharding are later slices (ROADMAP.md queue 1).

Numerics: on a CUDA device ``NWNet`` turns TF32 off for the process
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``). cuDNN runs f32 convolutions in
TF32 by default, about three decimal digits, which would break parity with
the f32 JAX featurizer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from nwhead_tpu_torch.nw.head import NWHead
from nwhead_tpu_torch.nw.support import SupportSetEval
from nwhead_tpu_torch.ops.fused_nw import PreparedSupport, prepare_support


class NWModel(nn.Module):
    """Featurizer + NW head."""

    def __init__(self, featurizer: nn.Module, n_classes: int,
                 kernel_type: str = "euclidean", head_precision: str = "f32") -> None:
        super().__init__()
        self.featurizer = featurizer
        self.head = NWHead(n_classes, kernel_type, head_precision)

    def featurize(self, x: torch.Tensor) -> torch.Tensor:
        return self.featurizer(x)

    def predict_from_prepared(self, qfeat: torch.Tensor, prepared: PreparedSupport) -> torch.Tensor:
        return self.head.from_prepared(qfeat, prepared)


class NWNet:
    """Serving orchestrator.

    :param featurizer: a backbone from ``nwhead_tpu_torch.models.load_model``.
    :param n_classes: number of classes.
    :param support_dataset: object with ``.targets`` and ``gather(indices) ->
        (n, H, W, C) float images``.
    :param device: where the weights, the bank and the computation live.

    The full bank is always prepared for the fused head, whatever its size
    (the JAX serving CLI's ``fused_min_support=1``).
    """

    def __init__(
        self,
        featurizer: nn.Module,
        n_classes: int,
        support_dataset=None,
        *,
        device: Union[str, torch.device],
        kernel_type: str = "euclidean",
        n_shot_full: int = 100,
        env_array: Optional[Sequence[int]] = None,
        head_precision: str = "f32",
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
        self.support_dataset = support_dataset
        self.precompute_batch = precompute_batch
        self.model = NWModel(featurizer, n_classes, kernel_type, head_precision)
        self.model.to(self.device).eval()
        if support_dataset is not None:
            self.support_eval = SupportSetEval(
                np.asarray(support_dataset.targets), n_classes, n_shot_full,
                env_array=env_array,
            )
        self._prepared_full: Optional[PreparedSupport] = None
        self._prepared_pos: Optional[np.ndarray] = None  # bank row -> prepared row

    # -- precompute ------------------------------------------------------------

    @torch.inference_mode()
    def precompute(self) -> None:
        """Featurize the full support bank (device-resident) and prepare it
        for the fused head."""
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
            out.append(self.model.featurize(x)[:n])
        return torch.cat(out)

    def _build_serving_banks(self) -> None:
        """Prepare the full bank for the fused head, and map each bank row to
        its prepared row (``prepare_support`` may sort rows by class)."""
        self.full_feat = self.support_eval.full_feat
        self.full_y = self.support_eval.full_y
        self._prepared_full, order = prepare_support(
            self.full_feat, self.full_y, self.n_classes,
            kernel=self.kernel_type, precision=self.model.head.precision,
            return_order=True,
        )
        S = len(self.full_y)
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
            raise ValueError("make_serving_fn needs the prepared full-mode bank: run precompute()")
        mean = std = None
        if normalize is not None:
            mean = torch.as_tensor(normalize[0], dtype=torch.float32, device=self.device)
            std = torch.as_tensor(normalize[1], dtype=torch.float32, device=self.device)
        model, device = self.model, self.device

        @torch.inference_mode()
        def serve(x) -> torch.Tensor:
            x = torch.as_tensor(x).to(device)
            if mean is not None:
                x = (x.to(torch.float32) * (1.0 / 255.0) - mean) / std
            return model.predict_from_prepared(model.featurize(x), self._prepared_full)

        return serve

    @torch.inference_mode()
    def predict(self, x, mode: str = "full") -> torch.Tensor:
        """Log-probs for a batch of images, served from the prepared bank
        (full mode; the other modes are later slices)."""
        self.support_eval.get_support(mode)  # raises for modes not ported, or before precompute
        qfeat = self.model.featurize(torch.as_tensor(x).to(self.device))
        return self.model.predict_from_prepared(qfeat, self._prepared_full)
