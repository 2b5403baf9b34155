"""NWNet: featurizer + NW head, episodic training forward, and inference.

Port of ``nwhead_tpu/nw/net.py``. ``NWModel`` holds the weights (featurizer,
optional projection, head) as an ``nn.Module``; its ``forward`` is the
episodic training forward, query and support in one featurizer batch so
that BatchNorm sees both and gradients reach the support features.
``NWNet`` is the host-side orchestrator: it samples training episodes
(``support_train``, ``forward``), builds the full-mode support bank and
its per-class k-means cluster bank (``precompute``), prepares the full bank
for the fused head when it is large enough (f32/bf16: K2; ``head_precision``
int8/int4: K4/K5), and predicts (``predict``, ``make_serving_fn``) in the
``random``, ``full`` and ``cluster`` modes (the head over the cluster bank:
K1 from ``fused_min_support`` rows on) and in mode ``ivf``, over the bank
tiles a batch routes to (``ops/ivf.py``, K6; ``calibrate_ivf`` sets its
knobs). ``get_neighbors`` ranks the full bank by score and
``support_influence`` gives each support item's leave-one-out influence
(``ops/influence.py``). Mode ``ensemble`` averages in probability space
the heads over the environments' banks (each a K1 launch from
``fused_min_support`` rows, padding rows masked), ``knn`` and ``hnsw``
run the head over the union of the batch's neighbours, exact
(``ops/knn.py``) or from the HNSW graph (``native/hnsw.py``).
``fuse_featurizer`` swaps the eval and serving featurizer of a ViT for the
bf16 fused-serving graph (K10/K11), ``quantize_featurizer`` that of a ViT,
ResNet/ResNeXt or DenseNet for the int8 one (K10/K11 int8; the CNNs' int8
convs, ``ops/int8_conv.py``); either remembers the weights it was built
from, and the eval and serving paths refuse to run once those changed
(``_check_serving_source``). With a ``mesh`` (``parallel/mesh.py``), ``precompute``
splits the bank over the mesh's support axis instead
(``parallel.ShardedSupportBank``) and modes ``full`` and ``ivf`` serve from
the shards, as do ``ensemble`` (each environment's bank split the same way)
and, over raw shards, ``knn``.

The installed bank is edited live, without a new featurizer pass over it
(JAX ``net.py:672-806``): ``add_support`` featurizes only the new images,
prepares only them and appends them to the prepared bank
(``concat_prepared``: O(new) work and one copy of the bank), and grows an
IVF bank by a chunk of the new rows (``concat_ivf``); ``remove_support``
tombstones rows in the prepared or sharded bank (``mask_prepared_rows``,
``ShardedSupportBank.remove_rows``: O(removed)) until a quarter of its
rows are dead, then prepares the bank again; ``restore_bank`` installs a
featurized bank. Serving callables read the bank at call time, so they
serve the edited bank.

``serving_module`` and ``mesh_serving_module`` build a serving callable's
pipeline as one ``ServingModule`` over a snapshot of the bank, for
``utils/aot.py``'s ``torch.export`` artifacts (a single-device callable
carries the hook, ``export_module``).

Numerics: on a CUDA device ``NWNet`` turns TF32 off for the process
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), for the backward convolutions
too. cuDNN runs f32 convolutions in TF32 by default, about three decimal
digits, which would break parity with the f32 JAX featurizer.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from nwhead_tpu_torch.nw.head import NWHead
from nwhead_tpu_torch.nw.support import SupportSetEval, SupportSetTrain
from nwhead_tpu_torch.ops.fused_nw import (
    PreparedSupport,
    _round_up,
    concat_prepared,
    inverse_order,
    mask_prepared_rows,
    prepare_for_concat,
    prepare_support,
)
from nwhead_tpu_torch.ops.influence import support_influence as _influence_op
from nwhead_tpu_torch.ops.ivf import (
    IVFAutoConfig,
    IVFPrepared,
    concat_ivf,
    ivf_auto_config,
    nw_fused_ivf_log_probs,
    prepare_support_ivf,
)
from nwhead_tpu_torch.ops.kernels import KERNEL_NAMES
from nwhead_tpu_torch.parallel import Mesh, ShardedSupportBank, sharded_ensemble_predict_fn


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


class ServingModule(nn.Module):
    """A serving callable's pipeline as one module, for ``torch.export``
    (``utils/aot.py``): [``(x / 255 - mean) / std`` ->] the eval featurizer
    [-> ``proj``] -> ``head`` (``PreparedHead``, ``IVFHead`` or, over a
    mesh, ``parallel.ShardedHead``). The normalization's statistics are
    buffers; the featurizer, the projection and the head are submodules,
    so their weights and the bank are stored tensors of an exported
    program, not constants of its graph (JAX ``aot.py:16-24``). Takes its
    input on the featurizer's device."""

    def __init__(self, featurizer: nn.Module, proj: Optional[nn.Module], head: nn.Module,
                 normalize=None, device=None) -> None:
        super().__init__()
        self.featurizer, self.proj, self.head = featurizer, proj, head
        stats = (None, None) if normalize is None else (
            torch.as_tensor(v, dtype=torch.float32, device=device) for v in normalize)
        for name, t in zip(("mean", "std"), stats):
            self.register_buffer(name, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mean is not None:
            x = (x.to(torch.float32) * (1.0 / 255.0) - self.mean) / self.std
        f = self.featurizer(x)
        return self.head(f if self.proj is None else self.proj(f))


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
    package) and the projection's init. ``n_shot_cluster`` centroids per
    class make the cluster bank, fitted by ``cluster_impl`` (``"device"`` or
    ``"sklearn"``, ``ops/kmeans.py``). ``n_neighbors`` is the knn and hnsw
    modes' neighbours a query; ``return_mask`` makes ``predict`` return an
    all-True mask beside the log-probs, as the reference does.
    ``ivf_n_probe`` (an int, or ``"auto"``: calibrated on the first ``ivf``
    batch or by ``calibrate_ivf``), ``ivf_n_clusters`` and ``ivf_group_b``
    are the knobs of mode ``ivf`` (``ops/ivf.py``). ``mesh`` shards the full bank over its
    support axis: no single-device prepared bank is built then, and the
    batch of a full or ivf predict splits over its data axis.
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
        n_shot_cluster: int = 1,
        cluster_impl: str = "device",
        n_neighbors: int = 10,
        env_array: Optional[Sequence[int]] = None,
        debug_mode: bool = False,
        return_mask: bool = False,
        use_fused: bool = True,
        fused_min_support: int = 1024,
        head_precision: str = "f32",
        seed: int = 0,
        precompute_batch: int = 128,
        ivf_n_probe: Union[int, str] = 32,
        ivf_n_clusters: Optional[int] = None,
        ivf_group_b: Optional[int] = None,
        mesh: Optional[Mesh] = None,
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
        self.return_mask = return_mask
        self.support_dataset = support_dataset
        self.precompute_batch = precompute_batch
        self.ivf_n_probe = ivf_n_probe
        self.ivf_n_clusters = ivf_n_clusters
        self.ivf_group_b = ivf_group_b
        self.mesh = mesh
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
                targets, n_classes, n_shot_random, n_shot_full, n_shot_cluster,
                n_neighbors=n_neighbors, env_array=env_array, seed=seed,
                cluster_impl=cluster_impl,
            )
        self._prepared_full: Optional[PreparedSupport] = None
        self._prepared_pos: Optional[np.ndarray] = None  # bank row -> prepared row
        self._prepared_dead = 0  # rows tombstoned since the bank was last prepared whole
        # (full_feat it was built from, IVF bank): rebuilt when precompute
        # replaces the bank features, grown by add_support.
        self._ivf_cache = None
        # The support-sharded bank (with a mesh) and its full-mode predict.
        self.sharded_bank: Optional[ShardedSupportBank] = None
        self._sharded_predict = None
        # Under a mesh: (the bank it was built over, predict) of knn and
        # ensemble, built at their first use.
        self._sharded_knn_cache = None
        self._sharded_ensemble_cache = None
        # Eval/serving featurizer set by fuse_featurizer or quantize_featurizer
        # (None: the model's), and what it was built from (_record_source).
        self.serving_featurizer: Optional[nn.Module] = None
        self._source = self._source_fp = None

    def process_support_eval(self, support_dataset, **kwargs) -> None:
        """Swap in a new eval support dataset (the reference's
        ``nw.py:107-116``): a new ``SupportSetEval`` over its targets with
        ``kwargs``; every bank built from the old one is dropped until the
        next ``precompute``."""
        self.support_dataset = support_dataset
        self.support_eval = SupportSetEval(np.asarray(support_dataset.targets),
                                           self.n_classes, **kwargs)
        self._drop_serving_banks()

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
                "fuse_featurizer is the ViT bf16 fused-serving path; for a "
                f"{type(self.model.featurizer).__name__} backbone use quantize_featurizer (int8) "
                "or load_model(..., dtype=torch.bfloat16)")
        self.serving_featurizer = fuse_vit_serving(self.model.featurizer)
        self._record_source()
        self._drop_serving_banks()

    def quantize_featurizer(self, calib_images, calib_batch: int = 64) -> None:
        """Swap the eval and serving featurizer for the int8 post-training-
        quantized one (``models/quantize.py``: a ViT's K10 int8 and K11 int8
        per block; a ResNet/ResNeXt's BN-folded int8 convs, a DenseNet's
        int8 convs between BatchNorm affines, both through
        ``ops/int8_conv.py``), its activation scales calibrated on
        ``calib_images`` (NHWC, post-transform) from the current weights.
        ``proj`` still applies. Training (``forward``) keeps the float
        featurizer. The prepared bank is dropped: run ``precompute`` after
        this, so that the bank is built from the same quantized features as
        the queries. The CIFAR models raise; serving only."""
        from nwhead_tpu_torch.models.quantize import quantize_featurizer

        self.serving_featurizer = quantize_featurizer(self.model.featurizer, calib_images,
                                                      calib_batch)
        self._record_source()
        self._drop_serving_banks()

    def _source_tensors(self):
        return list(self.model.featurizer.parameters()) + list(self.model.featurizer.buffers())

    @staticmethod
    def _versions(tensors):
        """Each tensor's in-place version counter (None for an inference
        tensor, which keeps none)."""
        return tuple(None if t.is_inference() else t._version for t in tensors)

    @staticmethod
    def _fingerprint(tensors):
        """Content fingerprint of the featurizer's weights, JAX's
        ``_variables_fingerprint``: (shape, dtype, sum) of the 4 smallest
        and the 4 largest tensors (small ones catch a BatchNorm or bias
        edit, large ones a swapped backbone), the sums read back at once."""
        by_size = sorted(tensors, key=lambda t: t.numel())
        picked = list({id(t): t for t in by_size[:4] + by_size[-4:]}.values())
        with torch.no_grad():
            sums = torch.stack([t.detach().to(torch.float64).sum() for t in picked]).tolist()
        return tuple((tuple(t.shape), str(t.dtype), s) for t, s in zip(picked, sums))

    def _record_source(self) -> None:
        """Remember the weights the serving featurizer was built from: the
        tensors themselves (held, so that their ids cannot be reused),
        their version counters and a content fingerprint."""
        tensors = self._source_tensors()
        self._source = (tensors, self._versions(tensors))
        self._source_fp = self._fingerprint(tensors)

    def _check_serving_source(self) -> None:
        """Raise if the featurizer's weights changed since the serving
        featurizer was built from them (it bakes them in), as JAX's
        ``_check_quantized_variables``. Fast path, no device work: the same
        tensor objects with the same version counters. Every in-place write
        bumps a tensor's counter (``load_state_dict``'s ``copy_``, an
        optimizer step, a BatchNorm's running statistics), and a replaced
        tensor is another object, so an unchanged pair means unchanged
        content. Otherwise (or for inference tensors, which keep no
        counter) the content fingerprint decides: equal content, as a reload
        of the same weights gives, is adopted; other content raises."""
        if self.serving_featurizer is None:
            return
        tensors = self._source_tensors()
        held, versions = self._source
        if (len(tensors) == len(held) and all(a is b for a, b in zip(tensors, held))
                and None not in versions and self._versions(tensors) == versions):
            return
        if self._fingerprint(tensors) != self._source_fp:
            raise RuntimeError(
                "the featurizer's weights changed since the serving featurizer was built from "
                "them (its weights are baked in at quantize_featurizer() / fuse_featurizer() "
                "time); re-run quantize_featurizer(calib_images) or fuse_featurizer() after "
                "loading new weights")
        self._source = (tensors, self._versions(tensors))

    def _eval_featurizer(self):
        """``(featurizer, proj)`` of the eval and serving paths: the fused or
        quantized serving featurizer when there is one, after the check that
        the weights it was built from are still the model's; else the
        model's."""
        self._check_serving_source()
        featurizer = self.serving_featurizer
        return featurizer if featurizer is not None else self.model.featurizer, self.model.proj

    def _featurize_eval(self, x: torch.Tensor) -> torch.Tensor:
        """Features of the eval and serving paths (``_eval_featurizer``)."""
        featurizer, proj = self._eval_featurizer()
        f = featurizer(x)
        return f if proj is None else proj(f)

    # -- precompute ------------------------------------------------------------

    @torch.inference_mode()
    def precompute(self) -> None:
        """Featurize the full support bank environment by environment
        (device-resident, eval mode), install it with its environment split
        (the environments' rows are views of the one bank), and prepare it
        for the fused head when it is large enough."""
        self.model.eval()
        feats, ys, metas = [], [], []
        envs = self.support_eval.envs
        for e, bank_idx in zip(envs.env_ids, self.support_eval.full_bank_indices):
            feats.append(self._featurize_bank(bank_idx))
            ys.append(envs.targets[bank_idx])
            metas.append(np.full(len(bank_idx), e))
        full = torch.cat(feats)
        del feats
        self.support_eval.build_infer_iters(
            full, np.concatenate(ys), np.concatenate(metas),
            list(full.split([len(y) for y in ys])), ys, metas)
        self._build_serving_banks()

    def _featurize_bank(self, bank_idx: np.ndarray) -> torch.Tensor:
        """Featurizer pass over the bank, its images gathered one batch at a
        time (``_featurize_batches``)."""
        return self._featurize_batches(
            len(bank_idx), lambda lo, hi: self.support_dataset.gather(bank_idx[lo:hi]))

    def _featurize_array(self, images) -> torch.Tensor:
        """Featurizer pass over an array of images (numpy or a tensor)."""
        return self._featurize_batches(len(images), lambda lo, hi: images[lo:hi])

    def _featurize_batches(self, n_images: int, batch) -> torch.Tensor:
        """Eval features of ``n_images`` images, ``batch(lo, hi)`` giving
        each ``precompute_batch`` of them; the last batch is zero-padded to
        the same shape and its padding rows dropped, so an image gets the
        same features from every caller."""
        bs = self.precompute_batch
        out = []
        for start in range(0, n_images, bs):
            x = torch.as_tensor(batch(start, start + bs)).to(self.device, torch.float32)
            n = x.shape[0]
            if n < bs:
                x = torch.cat([x, x.new_zeros((bs - n, *x.shape[1:]))])
            out.append(self._featurize_eval(x)[:n])
        return torch.cat(out)

    def _drop_serving_banks(self) -> None:
        """Forget every bank built from the current features (prepared,
        IVF, sharded, the sharded knn and ensemble predicts): a featurizer
        swap or a new ``precompute`` replaces them."""
        self._prepared_full = self._prepared_pos = self._ivf_cache = None
        self._prepared_dead = 0
        self.sharded_bank = self._sharded_predict = None
        self._sharded_knn_cache = self._sharded_ensemble_cache = None

    def _build_serving_banks(self, new_rows=None, keep_prepared=None, keep_sharded=None) -> None:
        """Prepare the full bank for the fused head when ``use_fused`` and it
        holds at least ``fused_min_support`` rows, and map each bank row to
        its prepared row (``prepare_support`` may sort rows by class). With
        a mesh, build the sharded bank instead (JAX ``net.py:641-670``):
        prepared at the head's precision with a routing index a shard when
        the kernel is a fused one, else raw f32.

        The bank edits pass what they keep (JAX ``net.py:485-670``):
        ``new_rows=(feats, labels, rows)`` (``add_support``, ``rows`` the new
        rows' positions in the grown bank) prepares only the new rows and
        appends them to the live prepared bank, and grows a live IVF bank
        by a chunk of them (meshless); ``keep_prepared=(prep, pos, dead)``
        and ``keep_sharded`` (``remove_support``) install a tombstoned
        bank.

        Every serving artifact is built aside and then installed by one
        assignment of each attribute, with no ``None`` in between, so a
        request served on another thread while a bank is edited or prepared
        again reads the old bank or the new one, never neither (JAX's
        ``net.py:525`` drops them first). The sharded knn and ensemble
        predicts, which no serving callable reads, are dropped and rebuilt
        at their next use."""
        full_feat, full_y = self.support_eval.full_feat, self.support_eval.full_y
        head = self.model.head
        self._sharded_knn_cache = self._sharded_ensemble_cache = None
        if self.mesh is not None:
            if keep_sharded is None:
                fused_ok = head.use_fused and self.kernel_type in KERNEL_NAMES
                keep_sharded = ShardedSupportBank.build(
                    full_feat, full_y, self.mesh, self.n_classes,
                    kernel=self.kernel_type, precision=head.precision if fused_ok else "f32",
                    use_prepared=None if fused_ok else False, ivf=fused_ok)
            # Trained kernel parameters (clip's logit_scale) ride along.
            predict = keep_sharded.predict_fn(kernel_params=head.kernel_params())
            self.full_feat, self.full_y = full_feat, full_y
            self.sharded_bank, self._sharded_predict = keep_sharded, predict
            self._ivf_cache = None  # the routed predict of the old bank
            return
        ivf = None
        if new_rows is not None and self._ivf_cache is not None:
            grown = self._grown_ivf(self._ivf_cache[1], *new_rows[:2])
            ivf = None if grown is None else (full_feat, grown)
        prep, pos, dead = None, None, 0
        S = len(full_y)
        if (head.use_fused and S >= head.fused_min_support
                and self.kernel_type in KERNEL_NAMES):
            prev_prep = self._prepared_full
            if keep_prepared is not None:
                prep, pos, dead = keep_prepared
            elif prev_prep is not None and new_rows is not None:
                feats, labels, rows = new_rows
                inc, order = prepare_for_concat(feats, labels, self.n_classes, prev_prep,
                                                kernel=self.kernel_type,
                                                precision=head.precision, return_order=True)
                prep = concat_prepared([prev_prep, inc])
                dead = self._prepared_dead
                # Old rows keep their prepared rows; the k-th new row is the
                # k-th input row of the new part (JAX net.py:603-626).
                new_pos = np.arange(len(labels), dtype=np.int64)
                if order is not None:
                    new_pos = inverse_order(order)[:len(labels)]
                pos = np.empty(S, np.int64)
                is_new = np.zeros(S, bool)
                is_new[rows] = True
                pos[~is_new] = self._prepared_pos
                pos[is_new] = prev_prep.labels.shape[0] + new_pos
            else:
                prep, order = prepare_support(
                    full_feat, full_y, self.n_classes,
                    kernel=self.kernel_type, precision=head.precision, return_order=True,
                )
                pos = np.arange(S, dtype=np.int64) if order is None else inverse_order(order)
        self.full_feat, self.full_y = full_feat, full_y
        self._ivf_cache = ivf
        self._prepared_full, self._prepared_pos, self._prepared_dead = prep, pos, dead

    def _grown_ivf(self, old: IVFPrepared, feats: torch.Tensor,
                   labels: np.ndarray) -> Optional[IVFPrepared]:
        """The IVF bank after an add (JAX ``net.py:533-571``): the new rows
        prepared as one chunk by ``prepare_support_ivf``, padded with masked
        rows to the live bank's tile, and appended by ``concat_ivf``; or
        None (a rebuild at the next ivf use) when the chunk does not
        concatenate."""
        blk = old.prep.block_s
        n = len(labels)
        pad = _round_up(n, blk) - n
        mask = torch.zeros(n + pad, dtype=torch.float32, device=feats.device)
        mask[:n] = 1.0
        inc = prepare_support_ivf(
            torch.nn.functional.pad(feats, (0, 0, 0, pad)),
            np.concatenate([labels, np.zeros(pad, np.int64)]), self.n_classes,
            kernel=self.kernel_type, precision=self.model.head.precision, support_mask=mask,
            block_s=blk)
        try:
            return concat_ivf([old, inc])
        except ValueError:
            return None

    def _check_labels(self, labels) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.int64)
        if labels.size and (labels.min() < 0 or labels.max() >= self.n_classes):
            raise ValueError(f"labels must lie in [0, {self.n_classes}); got "
                             f"[{labels.min()}, {labels.max()}]")
        return labels

    # -- bank edits ------------------------------------------------------------

    # The tombstoned share of a prepared or sharded bank's rows past which a
    # removal prepares the bank again: dead rows still stream through the
    # kernel, so past this the O(S) rebuild pays for itself (JAX net.py:711).
    _COMPACT_DEAD_FRAC = 0.25

    @torch.inference_mode()
    def add_support(self, images, labels, env_id: int = 0) -> None:
        """Add support items at serving time: ``images`` (NHWC, as
        ``precompute`` takes them) with ``labels`` in ``[0, n_classes)``, to
        environment ``env_id``. Only the new images go through the
        featurizer; the eval artifacts are rebuilt from the cached features
        (``SupportSetEval.extend_bank``), the prepared bank grows by the new
        rows alone (``concat_prepared``) and a live IVF bank by a chunk of
        them (``concat_ivf``); under a mesh the sharded bank is built again.
        Serving callables see the grown bank at their next call."""
        self._check_serving_source()
        labels = self._check_labels(labels)
        if labels.size == 0:
            return
        self.model.eval()
        feats = self._featurize_array(images)
        self.support_eval.extend_bank(feats, labels, env_id=env_id)
        # The new rows end their environment's segment, in input order.
        rows = np.nonzero(self.support_eval.full_meta == env_id)[0][-len(labels):]
        self._build_serving_banks(new_rows=(feats, labels, rows))

    @torch.inference_mode()
    def remove_support(self, indices) -> None:
        """Drop support items by their rows in the current bank order (as
        ``get_neighbors`` and ``support_influence`` number them); nothing is
        featurized. The prepared bank (or under a mesh the sharded one)
        tombstones the rows (``mask_prepared_rows``, ``remove_rows``) while
        its dead rows stay within ``_COMPACT_DEAD_FRAC`` of the rows it
        holds; past that it is prepared again from the rows kept. The
        port's full-mode bank is untiled, so it holds no padding rows that
        JAX's would count."""
        self._check_serving_source()
        idx = np.unique(np.asarray(indices, dtype=np.int64))
        prep, pos, dead, bank = (self._prepared_full, self._prepared_pos, self._prepared_dead,
                                 self.sharded_bank)
        n_before = len(getattr(self.support_eval, "full_y", ()))
        # Checks the indices before any bank is touched.
        self.support_eval.remove_bank_items(idx)
        if bank is not None and len(bank.rowmap) == n_before:
            if bank.dead + idx.size <= self._COMPACT_DEAD_FRAC * bank.capacity:
                self._build_serving_banks(keep_sharded=bank.remove_rows(idx))
                return
        elif prep is not None and len(pos) == n_before:
            dead += int(idx.size)
            if dead <= self._COMPACT_DEAD_FRAC * prep.labels.shape[0]:
                keep = np.ones(n_before, bool)
                keep[idx] = False
                self._build_serving_banks(
                    keep_prepared=(mask_prepared_rows(prep, pos[idx]), pos[keep], dead))
                return
        self._build_serving_banks()

    @torch.inference_mode()
    def restore_bank(self, feats, labels, meta=None) -> None:
        """Install a featurized support bank in place of ``precompute``:
        ``feats (S, D)``, ``labels (S,)`` and each row's environment
        ``meta`` (default one environment, 0). Rows are grouped by
        environment in the order the ids first appear, as ``precompute``
        lays them out; every eval and serving artifact is built as after
        ``precompute``."""
        self._check_serving_source()
        feats = torch.as_tensor(feats).to(self.device, torch.float32)
        labels = self._check_labels(torch.as_tensor(labels).cpu())
        meta = np.zeros(len(labels), np.int64) if meta is None else np.asarray(meta)
        if not len(feats) == len(labels) == len(meta):
            raise ValueError(f"bank size mismatch: {len(feats)} feats, {len(labels)} labels, "
                             f"{len(meta)} meta")
        envs = list(dict.fromkeys(meta.tolist()))
        order = np.concatenate([np.nonzero(meta == e)[0] for e in envs])
        if not np.array_equal(order, np.arange(len(order))):
            feats = feats[torch.as_tensor(order, device=self.device)]
        ys = [labels[meta == e] for e in envs]
        metas = [meta[meta == e] for e in envs]
        self.support_eval.build_infer_iters(feats, labels[order], meta[order],
                                            list(feats.split([len(y) for y in ys])), ys, metas)
        self._build_serving_banks()

    # -- inference -------------------------------------------------------------

    # -- IVF ---------------------------------------------------------------------

    def _ivf_bank(self) -> IVFPrepared:
        """The IVF bank of the current full-bank features (built from
        ``full_feat``/``full_y`` at ``head_precision``), built once and
        cached against ``full_feat``."""
        if getattr(self, "full_feat", None) is None:
            raise ValueError("mode='ivf' needs precompute() first")
        if self._ivf_cache is not None and self._ivf_cache[0] is self.full_feat:
            return self._ivf_cache[1]
        ivf = prepare_support_ivf(
            self.full_feat, self.full_y, self.n_classes, kernel=self.kernel_type,
            precision=self.model.head.precision, n_clusters=self.ivf_n_clusters)
        self._ivf_cache = (self.full_feat, ivf)
        return ivf

    def _ivf_head(self, qfeat: torch.Tensor, ivf: IVFPrepared, n_probe: int,
                  group_b: Optional[int]) -> torch.Tensor:
        return nw_fused_ivf_log_probs(
            qfeat, ivf, self.n_classes, kernel=self.kernel_type,
            kernel_params=self.model.head.kernel_params(),
            n_probe=min(n_probe, ivf.cents.shape[0]), group_b=group_b)

    def _sharded_ivf_fn(self):
        """Under a mesh: the sharded bank's routed predict (each shard routes
        against its own tiles), built once per bank."""
        bank = self.sharded_bank
        if bank is None or not bank.ivf:
            raise ValueError(
                "mode='ivf' under a mesh needs the prepared sharded bank with its routing "
                "index (a fused kernel on the card, or a reduced-precision head); "
                + ("run precompute() first" if bank is None else
                   "this bank was built without one"))
        if self._ivf_cache is not None and self._ivf_cache[0] is bank:
            return self._ivf_cache[1]
        if self.ivf_n_probe == "auto":
            raise ValueError(
                "ivf_n_probe='auto' is single-device only; under a mesh pick it explicitly "
                "(calibrate on a single-device build of the same bank — per-shard routed "
                "recall is a superset of the global route)")
        fn = bank.predict_fn(kernel_params=self.model.head.kernel_params(),
                             ivf_n_probe=self.ivf_n_probe)
        self._ivf_cache = (bank, fn)
        return fn

    def _ivf_predict(self, x) -> torch.Tensor:
        """IVF-pruned predict over the cached IVF bank; with ``ivf_n_probe
        == "auto"`` this first batch is the calibration sample. Under a
        mesh, the sharded bank's routed predict."""
        if self.mesh is not None:
            fn = self._sharded_ivf_fn()
            return fn(self._featurize_eval(torch.as_tensor(x).to(self.device)))
        ivf = self._ivf_bank()
        qfeat = self._featurize_eval(torch.as_tensor(x).to(self.device))
        if self.ivf_n_probe == "auto":
            self.calibrate_ivf(qfeat=qfeat)
        return self._ivf_head(qfeat, ivf, self.ivf_n_probe, self.ivf_group_b)

    @torch.inference_mode()
    def calibrate_ivf(self, x=None, qfeat=None, target_agree: float = 0.999,
                      **auto_kwargs) -> IVFAutoConfig:
        """Calibrate the IVF knobs against the exact head on a
        traffic-representative sample (``ops.ivf.ivf_auto_config``), pin
        ``ivf_n_probe``/``ivf_group_b`` and return the chosen point with its
        measured agreement. Pass images ``x`` (featurized as the serving
        path does) or features ``qfeat``. An ``ivf_group_b`` set by the user
        is the grouping candidate; calibration decides whether it engages."""
        if qfeat is None:
            if x is None:
                raise ValueError("pass x (images) or qfeat (features)")
            self.model.eval()
            qfeat = self._featurize_eval(torch.as_tensor(x).to(self.device))
        if qfeat.shape[0] < 32:
            warnings.warn(
                f"calibrate_ivf on only {qfeat.shape[0]} queries: the pinned (n_probe, "
                "group_b) is only as good as the sample; calibrate on a serving-sized "
                "representative batch", stacklevel=2)
        if isinstance(self.ivf_group_b, int) and "group_b" not in auto_kwargs:
            auto_kwargs["group_b"] = self.ivf_group_b
        cfg = ivf_auto_config(qfeat, self._ivf_bank(), self.n_classes, kernel=self.kernel_type,
                              kernel_params=self.model.head.kernel_params(),
                              target_agree=target_agree, **auto_kwargs)
        self.ivf_n_probe, self.ivf_group_b = cfg.n_probe, cfg.group_b
        return cfg

    # -- inference -------------------------------------------------------------

    def make_serving_fn(self, normalize=None, mode: str = "full"):
        """The per-request callable: ``(B, H, W, C) images -> (B, n_classes)
        log-probs`` composing normalize -> featurize -> head, the prepared
        full-mode head (``mode="full"``) or the IVF-pruned one (``"ivf"``,
        its knobs fixed now: an unresolved ``ivf_n_probe="auto"`` raises).
        Accepts numpy arrays or tensors on any device and returns a tensor
        on ``self.device``. ``normalize=(mean, std)`` applies ``(x/255 -
        mean)/std`` first (for uint8 pixels). The bank is read at call time,
        so a later ``precompute`` or bank edit reaches existing serving
        callables. Without a mesh the callable carries ``export_module``,
        which builds this pipeline as a ``ServingModule`` over the bank of
        the moment (``serving_module``), for ``utils/aot.py``."""
        if mode not in ("full", "ivf"):
            raise ValueError(f"make_serving_fn serves modes 'full' and 'ivf', got {mode!r}")
        self._check_serving_source()
        n_probe, group_b = self.ivf_n_probe, self.ivf_group_b
        if self.mesh is not None:
            if self._sharded_predict is None:
                raise ValueError("make_serving_fn under a mesh needs the sharded bank: run "
                                 "precompute() first")
            if mode == "ivf":
                self._sharded_ivf_fn()  # errors come early

            def head(qfeat):
                # Read at call time, so a later precompute or edit reaches
                # this callable.
                if self._sharded_predict is None:
                    raise ValueError("the sharded serving bank is gone (a featurizer swap or a "
                                     "new support set dropped it): run precompute() and "
                                     "rebuild the serving fn")
                if mode == "ivf":
                    return self._sharded_ivf_fn()(qfeat)
                return self._sharded_predict(qfeat)
        elif mode == "ivf":
            self._ivf_bank()  # built now: errors come early
            if self.ivf_n_probe == "auto":
                raise ValueError(
                    "ivf_n_probe='auto' is unresolved: call calibrate_ivf(x=...) on "
                    "representative traffic before make_serving_fn(mode='ivf') (the serving "
                    "callable fixes the knobs)")

            def head(qfeat):
                return self._ivf_head(qfeat, self._ivf_bank(), n_probe, group_b)
        elif self._prepared_full is None:
            raise ValueError("make_serving_fn needs the prepared full-mode bank: run "
                             "precompute() with use_fused and at least fused_min_support rows")
        else:
            def head(qfeat):
                return self.model.predict_from_prepared(qfeat, self._live_prepared())
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
            return head(self._featurize_eval(x))

        if self.mesh is None:
            # The AOT-export hook (utils/aot.py, JAX's ``fn._export_parts``):
            # this pipeline as a module over the bank of the moment.
            serve.export_module = lambda: self.serving_module(normalize, mode, n_probe,
                                                              group_b)
        return serve

    def serving_module(self, normalize=None, mode: str = "full", n_probe=None,
                       group_b=None) -> ServingModule:
        """``make_serving_fn``'s pipeline as a ``ServingModule`` over a
        snapshot of the current bank, in eval mode: the prepared bank's
        ``PreparedHead`` (``mode="full"``) or the IVF bank's ``IVFHead``
        (``"ivf"``, ``n_probe`` / ``group_b`` default the net's knobs; an
        unresolved ``"auto"`` raises). Single-device nets only; a mesh's
        is ``mesh_serving_module``."""
        from nwhead_tpu_torch.nw.head import IVFHead, PreparedHead

        if self.mesh is not None:
            raise ValueError("serving_module is single-device; under a mesh use "
                             "mesh_serving_module")
        featurizer, proj = self._eval_featurizer()
        params = self.model.head.kernel_params()
        if mode == "ivf":
            n_probe = self.ivf_n_probe if n_probe is None else n_probe
            group_b = self.ivf_group_b if group_b is None else group_b
            if n_probe == "auto":
                raise ValueError("ivf_n_probe='auto' is unresolved: call calibrate_ivf(x=...) "
                                 "before exporting mode='ivf'")
            head = IVFHead(self._ivf_bank(), self.n_classes, self.kernel_type, params, n_probe,
                           group_b)
        elif mode == "full":
            head = PreparedHead(self._live_prepared(), self.n_classes, self.kernel_type, params)
        else:
            raise ValueError(f"serving_module serves modes 'full' and 'ivf', got {mode!r}")
        return ServingModule(featurizer, proj, head, normalize, self.device).eval()

    def mesh_serving_module(self, normalize=None) -> ServingModule:
        """The mesh's full-mode pipeline as a ``ServingModule``: the eval
        featurizer on the net's device, then ``parallel.ShardedHead`` over a
        prepared snapshot of the sharded bank (a raw-mode bank's live rows
        prepared at export, JAX ``aot.py:177-191``), in eval mode."""
        from nwhead_tpu_torch.parallel.sharded_bank import ShardedHead

        if self.mesh is None or self.sharded_bank is None:
            raise ValueError("mesh_serving_module needs a NWNet built with mesh= and a "
                             "precomputed sharded bank: run precompute() first")
        featurizer, proj = self._eval_featurizer()
        head = ShardedHead(self.sharded_bank, self.model.head.kernel_params())
        return ServingModule(featurizer, proj, head, normalize, self.device).eval()

    def _live_prepared(self) -> PreparedSupport:
        """The prepared bank a full-mode serving callable reads at call time
        (JAX ``net.py:1044``): a loud error where an edit or a swap left
        none."""
        if self._prepared_full is None:
            raise ValueError(
                "the prepared serving bank no longer exists (the bank shrank below "
                "fused_min_support, the support set was swapped, or the featurizer was "
                "re-quantized): run precompute() / restore_bank() and rebuild via "
                "make_serving_fn")
        return self._prepared_full

    @torch.inference_mode()
    def predict(self, x, mode: str = "random"):
        """Log-probs for a batch of images, in eval mode, and with
        ``return_mask`` an all-True mask ``(B,)`` beside them. ``random``:
        the head over an episode drawn from the bank; ``full``: the prepared
        bank (K2, K4 or K5) when there is one, else the head over the whole
        bank; ``cluster``: the head over the cluster bank; ``ensemble``: the
        mean in probability space of the heads over each environment's bank;
        ``knn`` / ``hnsw``: the head over the union of the batch's
        ``n_neighbors`` nearest bank rows, exact or from the HNSW graph (a
        row several queries share counts several times); ``ivf``: the
        IVF-pruned head (K6) over the tiles the batch routes to. The head
        takes K1 over a support of at least ``fused_min_support`` rows.
        Under a mesh full and ivf go through the sharded bank (its shards'
        partials, K1 or K2/K4/K5/K6 ``partials=True``), ensemble through
        each environment's shards (K1 ``partials=True``), and knn through
        raw shards when each holds at least ``n_neighbors`` rows (otherwise
        the exact search over the device's bank). The dispatch order is the
        JAX package's."""
        self.model.eval()
        out = self._predict(x, mode)
        if self.return_mask:
            return out, np.full((len(x),), True)
        return out

    def _predict(self, x, mode: str) -> torch.Tensor:
        if mode == "ivf":
            return self._ivf_predict(x)
        qfeat = self._featurize_eval(torch.as_tensor(x).to(self.device))
        if mode == "full" and self._sharded_predict is not None:
            return self._sharded_predict(qfeat)
        if mode == "full" and self._prepared_full is not None:
            return self.model.predict_from_prepared(qfeat, self._prepared_full)
        bank = self.sharded_bank
        k = self.support_eval.n_neighbors
        if (mode == "knn" and bank is not None and not bank.prepared and k <= bank.local
                and k <= len(self.support_eval.full_y)):
            return self._knn_sharded(qfeat)
        if mode == "ensemble" and self.mesh is not None:
            return self._ensemble_sharded(qfeat)
        support = self.support_eval.get_support(mode, x=qfeat)
        if mode == "ensemble":
            return self._ensemble_from_feats(qfeat, *support)
        return self.model.head(qfeat, *support)

    def _ensemble_from_feats(self, qfeat: torch.Tensor, ens_feat: torch.Tensor,
                             ens_y: torch.Tensor, ens_mask: torch.Tensor) -> torch.Tensor:
        """The mean in probability space of the heads over the stacked
        environment banks (``nw.py:143-154``): for each environment in
        order, the head over its padded bank with its mask (K1 from
        ``fused_min_support`` rows), then ``log(sum of exp / E)``."""
        total = None
        for f, y, m in zip(ens_feat, ens_y, ens_mask):
            p = torch.exp(self.model.head(qfeat, f, y, m))
            total = p if total is None else total + p
        return torch.log(total / ens_feat.shape[0])

    def _knn_sharded(self, qfeat: torch.Tensor) -> torch.Tensor:
        """The sharded exact k-NN predict over the raw sharded bank, built
        once per bank."""
        cached = self._sharded_knn_cache
        if cached is None or cached[0] is not self.sharded_bank:
            fn = self.sharded_bank.knn_predict_fn(self.support_eval.n_neighbors,
                                                  kernel_params=self.model.head.kernel_params())
            cached = self._sharded_knn_cache = (self.sharded_bank, fn)
        return cached[1](qfeat)

    def _ensemble_sharded(self, qfeat: torch.Tensor) -> torch.Tensor:
        """The ensemble over the mesh: each environment's bank padded to a
        common length, a multiple of the shard count, stacked on the host
        and split over the support axis (no single device holds the stack),
        built once per installed bank (``parallel.sharded_ensemble_predict_fn``)."""
        sep = self.support_eval.full_feat_sep
        cached = self._sharded_ensemble_cache
        if cached is None or cached[0] is not sep:
            n_shards = self.mesh.shape["support"]
            s_pad = -(-max(len(f) for f in sep) // n_shards) * n_shards
            D = sep[0].shape[1]
            ens_feat = torch.zeros((len(sep), s_pad, D), dtype=torch.float32)
            ens_y = torch.zeros((len(sep), s_pad), dtype=torch.int32)
            ens_mask = torch.zeros((len(sep), s_pad), dtype=torch.float32)
            for e, (f, y) in enumerate(zip(sep, self.support_eval.full_y_sep)):
                ens_feat[e, :len(f)] = f.to("cpu", torch.float32)
                ens_y[e, :len(y)] = torch.as_tensor(y)
                ens_mask[e, :len(f)] = 1.0
            fn = sharded_ensemble_predict_fn(self.mesh, ens_feat, ens_y, ens_mask,
                                             self.n_classes, kernel=self.kernel_type,
                                             kernel_params=self.model.head.kernel_params())
            cached = self._sharded_ensemble_cache = (sep, fn)
        return cached[1](qfeat)

    # -- explainability --------------------------------------------------------

    @torch.inference_mode()
    def get_neighbors(self, x) -> np.ndarray:
        """Full-bank row indices ``(B, S)`` by descending score for each
        image of ``x``; among equal scores the larger index comes first
        (the JAX package's stable ascending sort, reversed)."""
        self.model.eval()
        qfeat = self._featurize_eval(torch.as_tensor(x).to(self.device))
        scores = self.model.head.scores(qfeat, self.support_eval.full_feat)[:, 0, :]
        return torch.argsort(scores, dim=-1, stable=True).flip(-1).cpu().numpy()

    @torch.inference_mode()
    def support_influence(self, x, y, mode: str = "full") -> np.ndarray:
        """Leave-one-out influence ``(B, S)`` of each support item of
        ``mode`` on the images ``x`` with labels ``y``, from the naive
        head's probabilities and softmax weights."""
        if mode == "ensemble":
            raise ValueError(
                "support_influence is per-support-set; run it per environment (mode='full' "
                "on a net whose support is one environment) instead of 'ensemble'")
        self.model.eval()
        qfeat = self._featurize_eval(torch.as_tensor(x).to(self.device))
        sfeat, sy = self.support_eval.get_support(mode, x=qfeat)
        probs, weights = self.model.head.probs_and_weights(qfeat, sfeat, sy)
        y = torch.as_tensor(np.asarray(y), device=self.device)
        return _influence_op(probs, y, weights, sy).cpu().numpy()
