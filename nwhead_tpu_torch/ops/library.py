"""The serving kernels as ``torch.library`` custom ops.

Every kernel that a serving callable of ``NWNet.make_serving_fn`` can
reach is registered here as one op under the ``nwhead_torch`` namespace,
with three implementations and no other:

* CPU: the kernel's plain PyTorch version;
* CUDA: the kernel's wrapper (``nw_prepared_cuda`` and its kin in
  ``ops/fused_nw.py``, ``attention_qkv_cuda`` and the half-blocks in
  ``ops/fused_attn.py``, ``mlp_cuda`` and the half-blocks in
  ``ops/fused_mlp.py``), which keeps its checks, its ``.launches`` count and
  its rule to raise rather than fall back;
* fake: the output's shape and dtype only, for ``torch.export`` and
  ``FakeTensorMode``. It touches no library, no card property and no
  stream; a tensor on any device other than the CPU or a CUDA card (a
  ``meta`` tensor included) raises there.

The live serving path calls these ops (``nw_fused_from_prepared``, the ViT
half-blocks, the forwards of ``fused_attention_qkv`` and ``fused_mlp``),
so a program exported from it (``utils/aot.py``) runs the same kernels. A
``PreparedSupport`` crosses an op boundary as its tensors: ``s``, ``s2``
(optional), ``labels``, ``sscale`` (optional) and, for ``tile_sel``, the
int ``block_s``.

| op | kernel | CUDA wrapper |
|---|---|---|
| ``nw_prepared`` | K2 (f32 / bf16 bank) | ``nw_prepared_cuda`` |
| ``nw_prepared_int8`` / ``_int4`` | K4 / K5 | ``nw_prepared_int8_cuda`` / ``_int4_cuda`` |
| ``nw_prepared_partials`` (``_int8``, ``_int4``) | K2 / K4 / K5 ``partials=True`` | ``nw_prepared_partials*_cuda`` |
| ``nw_prepared_sel`` / ``_sel_quant`` | K6 ``tile_sel`` | ``nw_prepared_sel_cuda`` / ``_sel_quant_cuda`` |
| ``attention_qkv`` | K7 forward | ``attention_qkv_cuda`` |
| ``mlp`` | K9 forward | ``mlp_cuda`` |
| ``attention_block_bf16`` / ``_int8`` | K10 / K10 int8 | ``attention_block_bf16_cuda`` / ``_int8_cuda`` |
| ``mlp_block_bf16`` / ``_int8`` | K11 / K11 int8 | ``mlp_block_bf16_cuda`` / ``_int8_cuda`` |

Training's backward kernels (K3, K8, the K9 backward), K1 and K6
``partials`` are not on a serving callable's path and are called directly.
Importing this module builds nothing and loads no library.
"""

import torch

from nwhead_tpu_torch.ops import fused_attn as FA
from nwhead_tpu_torch.ops import fused_mlp as FM
from nwhead_tpu_torch.ops import fused_nw as FN

NAMESPACE = "nwhead_torch"
_DEVICES = ("cpu", "cuda")


def _fake_device(name: str, t: torch.Tensor) -> None:
    """The fake implementations' one check: the op has no implementation
    for any other device (a ``meta`` tensor reaches the fake one)."""
    if t.device.type not in _DEVICES:
        raise ValueError(f"{NAMESPACE}::{name} runs on the CPU (plain version) or a CUDA card "
                         f"(kernel), not on {t.device}")


def _late(module, name: str):
    """``module.name`` looked up at each call, so that a wrapper or plain
    version swapped on its module (a timing or parity harness) is the one
    that runs."""
    def call(*args):
        return getattr(module, name)(*args)

    return call


def _define(name: str, schema: str, plain, cuda, fake):
    """One custom op: ``plain`` for CPU tensors, ``cuda`` for CUDA tensors,
    ``fake`` (after the device check) for shapes."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda", cuda)

    def checked_fake(*args):
        _fake_device(name, args[0])
        return fake(*args)

    op.register_fake(checked_fake)
    return op


# -- the prepared-bank head: K2, K4, K5 and their partials -------------------

_PREP_ARGS = ("Tensor q, Tensor s, Tensor? s2, Tensor labels, Tensor? sscale, Tensor scale, "
              "Tensor? qscale, str mode, int n_classes")


def _prepared_op(name: str, partials: bool):
    def plain(q, s, s2, labels, sscale, scale, qscale, mode, n_classes):
        return FN._nw_prepared_plain(q, FN.PreparedSupport(s, s2, labels, sscale), scale, mode,
                                     n_classes, qscale, partials)

    def cuda(q, s, s2, labels, sscale, scale, qscale, mode, n_classes):
        return getattr(FN, f"{name}_cuda")(q, FN.PreparedSupport(s, s2, labels, sscale), scale,
                                           mode, n_classes, qscale)

    def fake(q, s, s2, labels, sscale, scale, qscale, mode, n_classes):
        B = q.shape[0]
        if partials:
            return (q.new_empty((B, 1), dtype=torch.float32),
                    q.new_empty((B, 1), dtype=torch.float32),
                    q.new_empty((B, n_classes), dtype=torch.float32))
        return q.new_empty((B, n_classes), dtype=torch.float32)

    out = "(Tensor, Tensor, Tensor)" if partials else "Tensor"
    return _define(name, f"({_PREP_ARGS}) -> {out}", plain, cuda, fake)


nw_prepared = _prepared_op("nw_prepared", False)
nw_prepared_int8 = _prepared_op("nw_prepared_int8", False)
nw_prepared_int4 = _prepared_op("nw_prepared_int4", False)
nw_prepared_partials = _prepared_op("nw_prepared_partials", True)
nw_prepared_partials_int8 = _prepared_op("nw_prepared_partials_int8", True)
nw_prepared_partials_int4 = _prepared_op("nw_prepared_partials_int4", True)


# -- K6: the head over the tiles a list names ----------------------------------


def _sel_op(name: str):
    def plain(q, s, s2, labels, sscale, scale, qscale, tile_sel, block_s, mode, n_classes):
        return FN._nw_prepared_sel_plain(q, FN.PreparedSupport(s, s2, labels, sscale, block_s),
                                         scale, mode, n_classes, qscale, tile_sel)

    def cuda(q, s, s2, labels, sscale, scale, qscale, tile_sel, block_s, mode, n_classes):
        return getattr(FN, f"{name}_cuda")(q, FN.PreparedSupport(s, s2, labels, sscale, block_s),
                                           scale, mode, n_classes, qscale, tile_sel)

    def fake(q, s, s2, labels, sscale, scale, qscale, tile_sel, block_s, mode, n_classes):
        return q.new_empty((q.shape[0], n_classes), dtype=torch.float32)

    schema = (f"({_PREP_ARGS.replace('str mode', 'Tensor tile_sel, int block_s, str mode')}) "
              "-> Tensor")
    return _define(name, schema, plain, cuda, fake)


nw_prepared_sel = _sel_op("nw_prepared_sel")
nw_prepared_sel_quant = _sel_op("nw_prepared_sel_quant")


# -- the ViT kernels: K7 and K9 forward, the half-blocks K10 and K11 ------------

attention_qkv = _define(
    "attention_qkv", "(Tensor qkv, int num_heads, float scale) -> Tensor",
    _late(FA, "_attention_qkv_plain"), _late(FA, "attention_qkv_cuda"),
    lambda qkv, num_heads, scale: qkv.new_empty((*qkv.shape[:2], qkv.shape[2] // 3)))

mlp = _define(
    "mlp", "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    _late(FM, "_mlp_plain"), _late(FM, "mlp_cuda"),
    lambda x, w1, b1, w2, b2: x.new_empty((x.shape[0], w2.shape[-1])))

_FOLDS = "Tensor? ln_scale, Tensor? ln_bias, float ln_eps, Tensor? layerscale, bool residual"

attention_block_bf16 = _define(
    "attention_block_bf16",
    "(Tensor x, Tensor w_qkv, Tensor b_qkv, Tensor w_proj, Tensor b_proj, int num_heads, "
    f"float scale, {_FOLDS}) -> Tensor",
    _late(FA, "_attention_block_bf16_plain"), _late(FA, "attention_block_bf16_cuda"),
    lambda x, *rest: torch.empty_like(x))

attention_block_int8 = _define(
    "attention_block_int8",
    "(Tensor x, Tensor w_qkv, Tensor s_qkv, Tensor b_qkv, float a_qkv, Tensor w_proj, "
    "Tensor s_proj, Tensor b_proj, float a_proj, int num_heads, float scale, "
    f"{_FOLDS}) -> Tensor",
    _late(FA, "_attention_block_int8_plain"), _late(FA, "attention_block_int8_cuda"),
    lambda x, *rest: torch.empty_like(x))

mlp_block_bf16 = _define(
    "mlp_block_bf16",
    f"(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, {_FOLDS}) -> Tensor",
    _late(FM, "_mlp_block_bf16_plain"), _late(FM, "mlp_block_bf16_cuda"),
    lambda x, w1, b1, w2, b2, *rest: x.new_empty((x.shape[0], w2.shape[-1])))

mlp_block_int8 = _define(
    "mlp_block_int8",
    "(Tensor x, Tensor w1, Tensor s1, Tensor b1, float a1, Tensor w2, Tensor s2, Tensor b2, "
    f"float a2, {_FOLDS}) -> Tensor",
    _late(FM, "_mlp_block_int8_plain"), _late(FM, "mlp_block_int8_cuda"),
    lambda x, w1, s1, b1, a1, w2, *rest: x.new_empty((x.shape[0], w2.shape[-1])))

# Each op's name -> its CUDA wrapper (module, name), whose ``.launches``
# counts the op's launches on a card.
WRAPPERS = {
    **{name: (FN, f"{name}_cuda") for name in (
        "nw_prepared", "nw_prepared_int8", "nw_prepared_int4", "nw_prepared_partials",
        "nw_prepared_partials_int8", "nw_prepared_partials_int4", "nw_prepared_sel",
        "nw_prepared_sel_quant")},
    **{name: (FA, f"{name}_cuda") for name in (
        "attention_qkv", "attention_block_bf16", "attention_block_int8")},
    **{name: (FM, f"{name}_cuda") for name in ("mlp", "mlp_block_bf16", "mlp_block_int8")},
}


def launches() -> dict:
    """Each op's launches on a card so far (its wrapper's count)."""
    return {name: getattr(module, attr).launches for name, (module, attr) in WRAPPERS.items()}
