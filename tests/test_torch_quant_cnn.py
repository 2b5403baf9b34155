"""The port's int8 CNN featurizers against the JAX package: the BN-folded
ResNet/ResNeXt PTQ and the affine-BN DenseNet PTQ (``models/quantize.py``),
the exact int32 conv route (``ops/int8_conv.py``), the weights carried
across (``models/convert.py``), the ``.npz`` artifacts of all three families
and the slice end to end.

The JAX trees come from ``jax.eval_shape`` filled by numpy
(``tests/test_torch_zoo.py``'s ``_fill``), then three train-mode passes over
the calibration images give the BatchNorms the data's statistics, as
``tests/test_quantize.py``'s ``_init_trained_like`` does; the port's model
loads the same tree. 32 px images: resnet10 at B=4, resnet50,
resnext50_32x4d and densenet121 at B=2.

* The folded f32 forward equals the model's eval forward and JAX's
  ``folded_forward`` within rtol = atol = 2e-4.
* ``wq``, ``w_scale`` and ``bias`` equal JAX's bit for bit, the activation
  scales within rtol 1e-5 (two f32 calibration forwards).
* On the same codes one conv's int32 sums equal JAX's (grouped too, and
  sums past 2^24); a ``QConv``, the bf16 stem and the bf16 transition pool
  equal JAX's on the same input; the CUDA route's im2col and GEMM, run on
  the CPU (``torch._int_mm`` has a CPU kernel), equal the plain version.
* The port's ``QuantizedResNet`` / ``QuantizedDenseNet`` carried across
  from JAX's: within 1e-2 of max|JAX| with every row's cosine >= 0.9999
  (measured bit-equal). The DenseNet is held to JAX's forward compiled
  with XLA's ``xla_allow_excess_precision`` off: by default XLA's CPU
  compiler keeps the bf16 values inside a fusion in f32, which moves
  JAX's own compiled features from its op-by-op ones (measured 0.099 of
  max at this seed, the ResNets untouched); with the option off the
  compiled forward rounds at every op, as JAX's op-by-op forward and the
  port do.
* The slice: ``NWNet.quantize_featurizer`` + ``precompute`` +
  ``make_serving_fn`` against JAX's ``quantize_featurizer`` + ``precompute``
  + ``predict('full')``, f32 and int8 heads: probabilities within 2e-3,
  equal argmax.
* Artifacts: JAX's ``save_quantized`` file loads in the port, the port's
  file in JAX, and the port's round trip, each bit-equal, for the ResNet,
  DenseNet and ViT families.
* The serve and eval CLIs with ``--arch resnet10 --featurizer_precision
  int8 --device cpu``.

The CUDA route is tested on the card only (marker ``gpu``): bit-equal to
its plain version at B=64 on ResNet-50's, ResNeXt-50's and DenseNet-121's
shapes, its launch count moving. They run with ``python -m pytest
--noconftest -m gpu tests/test_torch_quant_cnn.py``; this file imports jax
only inside the JAX comparisons.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nwhead_tpu_torch.models import load_model
from nwhead_tpu_torch.models import quantize as TQ
from nwhead_tpu_torch.ops import int8_conv as IC

torch.set_num_threads(1)

ARCHS = {"resnet10": 4, "resnet50": 2, "resnext50_32x4d": 2, "densenet121": 2}
RESNETS = ("resnet10", "resnet50", "resnext50_32x4d")
REL = 1e-2


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _min_cos(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                             * np.linalg.norm(want, axis=-1))).min())


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """JAX's model, trained-like numpy variables, its quantized featurizer
    (calibrated on the images ``x``), and the port's model on the same
    weights with its own quantized featurizer."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.models.quantize import quantize_featurizer as jax_quantize
    from nwhead_tpu_torch.models.convert import jax_to_torch_featurizer
    from test_torch_zoo import _fill, _jax_fns, _shapes

    x = _x((ARCHS[arch], 32, 32, 3))
    model, fwd, fwd_train = _jax_fns(arch)
    variables = _fill(_shapes(model, jnp.asarray(x)))
    for _ in range(3):  # BatchNorm statistics of the data, as training leaves them
        _, upd = fwd_train(variables, jnp.asarray(x))
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}
    net = load_model(arch, device="cpu")
    net.load_state_dict(jax_to_torch_featurizer(variables))
    return SimpleNamespace(x=x, model=model, variables=variables, fwd=fwd, net=net,
                           jq=jax_quantize(model, variables, jnp.asarray(x)),
                           tq=TQ.quantize_featurizer(net, x))


def _convs(q):
    """Every quantized conv of a JAX or port quantized CNN, in forward order."""
    if hasattr(q, "final_bn"):
        out = [c for block in q.blocks for layer in block for c in (layer.conv1, layer.conv2)]
        trans = [t for t in q.transitions if t is not None]
        return out + [t[1] if isinstance(t, tuple) else t.conv for t in trans]
    out = []
    for blk in q.blocks:
        out += list(blk.convs) + ([blk.downsample] if blk.downsample is not None else [])
    return out


def _carry(jq):
    from nwhead_tpu_torch.models.convert import (
        jax_to_torch_quantized_densenet, jax_to_torch_quantized_resnet,
    )

    if hasattr(jq, "final_bn"):
        return jax_to_torch_quantized_densenet(jq)
    return jax_to_torch_quantized_resnet(jq)


def _feats(q, x) -> np.ndarray:
    return q(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("arch", RESNETS)
def test_folded_forward_matches_eval_and_jax(arch):
    import jax.numpy as jnp

    from nwhead_tpu.models.quantize import folded_forward as jax_folded

    s = _setup(arch)
    got = TQ.folded_forward(s.net, torch.from_numpy(s.x)).numpy()
    with torch.no_grad():
        eval_feats = s.net(torch.from_numpy(s.x)).numpy()
    np.testing.assert_allclose(got, eval_feats, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jax_folded(s.model, s.variables, jnp.asarray(s.x))),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_weights_and_scales_match_jax(arch):
    """The fold and the weight quantization bit for bit; the activation
    scales within rtol 1e-5; the same structure (strides, paddings,
    groups)."""
    from nwhead_tpu_torch.models.quantize import _padding

    s = _setup(arch)
    jc, tc = _convs(s.jq), _convs(s.tq)
    assert len(jc) == len(tc) > 0
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.wq.numpy(), np.asarray(j.wq))
        np.testing.assert_array_equal(t.w_scale.numpy(), np.asarray(j.w_scale))
        np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias))
        np.testing.assert_allclose(t.act_scale, float(j.act_scale), rtol=1e-5)
        assert (t.stride, t.padding, t.groups) == (j.stride, _padding(j.padding), j.groups)
    if arch.startswith("resnext"):
        assert {t.groups for t in tc} == {1, 32}


# (name, B, H, cin, cout, k, stride, padding, groups, codes): conv cases on the
# same codes; "extreme" sums 4,608 products of 127 * 127, past 2^24.
CONV_CASES = [
    ("3x3", 2, 9, 16, 24, 3, 1, 1, 1, "random"),
    ("1x1_s2", 2, 9, 32, 64, 1, 2, 0, 1, "random"),
    ("3x3_s2", 2, 10, 16, 16, 3, 2, 1, 1, "random"),
    ("grouped_32x4", 2, 8, 128, 128, 3, 2, 1, 32, "random"),
    ("extreme", 1, 4, 512, 8, 3, 1, 1, 1, "extreme"),
]


def _conv_operands(B, H, cin, cout, k, groups, codes, seed=0):
    rng = np.random.default_rng(seed)
    if codes == "extreme":
        x8 = np.full((B, H, H, cin), 127, np.int8)
        wq = np.full((k, k, cin // groups, cout), 127, np.int8)
        wq[..., 1::2] = -127
    else:
        x8 = rng.integers(-127, 128, (B, H, H, cin)).astype(np.int8)
        wq = rng.integers(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    return x8, wq


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int32_conv_matches_jax(case):
    import jax
    import jax.numpy as jnp

    _, B, H, cin, cout, k, stride, padding, groups, codes = case
    x8, wq = _conv_operands(B, H, cin, cout, k, groups, codes)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(wq), (stride, stride), ((padding, padding),) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32))
    got = IC.int8_conv2d(torch.from_numpy(x8), torch.from_numpy(wq), stride, padding, groups)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if codes == "extreme":
        assert np.abs(want).max() > 2 ** 24


# The CUDA route's arithmetic on the CPU: its im2col and zero-padded GEMM
# against the plain version, at the cases above and at shapes that need
# padding (rows <= 16, K and N not multiples of 8).
ROUTE_CASES = CONV_CASES + [
    ("few_rows", 1, 3, 8, 16, 1, 1, 0, 1, "random"),
    ("odd_k_n", 2, 7, 3, 12, 3, 2, 1, 1, "random"),
    ("grouped_odd", 1, 6, 12, 6, 3, 1, 1, 3, "random"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_cuda_route_arithmetic_matches_plain_on_cpu(case):
    _, B, H, cin, cout, k, stride, padding, groups, codes = case
    x8, wq = (torch.from_numpy(a) for a in _conv_operands(B, H, cin, cout, k, groups, codes))
    a, (b, ho, wo) = IC._im2col(x8, k, k, stride, padding)
    w_gemm = IC.gemm_weight(wq, groups)
    assert w_gemm.shape == (cout, k * k * cin) and w_gemm.is_contiguous()
    got = IC._gemm(a, w_gemm).reshape(b, ho, wo, cout)
    assert torch.equal(got, IC._int8_conv2d_plain(x8, wq, stride, padding, groups))


# Every ImageNet CNN of the registry and its int8 convs (the stem excluded).
QUANTIZABLE = {"resnet18": 8 * 2 + 3, "resnet34": 16 * 2 + 3, "resnet101": 33 * 3 + 4,
               "resnet152": 50 * 3 + 4, "resnext101_32x8d": 33 * 3 + 4,
               "densenet161": 2 * (6 + 12 + 36 + 24) + 3,
               "densenet169": 2 * (6 + 12 + 32 + 32) + 3,
               "densenet201": 2 * (6 + 12 + 48 + 32) + 3}


@pytest.mark.parametrize("name", list(QUANTIZABLE))
def test_quantize_featurizer_takes_every_imagenet_cnn(name):
    """The registry's other ImageNet ResNets, ResNeXts and DenseNets
    quantize (random weights, 32 px): the family's featurizer with one
    ``QConv`` a conv but the stem, finite features of the model's width."""
    model = load_model(name, device="cpu", generator=torch.Generator().manual_seed(0))
    q = TQ.quantize_featurizer(model, _x((2, 32, 32, 3), seed=6))
    family = TQ.QuantizedDenseNet if name.startswith("densenet") else TQ.QuantizedResNet
    assert isinstance(q, family)
    assert sum(isinstance(m, TQ.QConv) for m in q.modules()) == QUANTIZABLE[name]
    feats = _feats(q, _x((1, 32, 32, 3), seed=7))
    assert feats.shape == (1, model.feat_dim) and np.isfinite(feats).all()


def test_int8_conv2d_cuda_refuses_cpu_tensors():
    x8 = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    before = IC.int8_conv2d_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        IC.int8_conv2d_cuda(x8, wq, 1, 1)
    assert IC.int8_conv2d_cuda.launches == before


def test_qconv_stem_and_pool_match_jax():
    """On the same bf16 input: one ``QConv`` (the quantize, int32 conv,
    dequantize chain), the bf16 stem (conv, max-pool, bias, ReLU) and the
    transition's bf16 2x2 pool equal JAX's bit for bit."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.models import quantize as JQ

    s = _setup("resnet10")
    x = _x((2, 16, 16, 64), seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    for jc, tc in zip(_convs(s.jq)[:3], _convs(s.tq)[:3]):
        if tc.wq.shape[2] != 64:
            continue
        want = np.asarray(JQ._qconv_apply(xj, jc).astype(jnp.float32))
        np.testing.assert_array_equal(tc(xb).float().numpy(), want)

    img = _x((2, 32, 32, 3), seed=4)
    jq = s.jq

    def jax_stem(x):
        y = jax.lax.conv_general_dilated(
            x.astype(jnp.bfloat16), jq.stem_w, (2, 2), jq.stem_padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = jax.lax.reduce_window(y, jnp.bfloat16(-jnp.inf), jax.lax.max, (1, 3, 3, 1),
                                  (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0)))
        return jax.nn.relu(y + jq.stem_b.astype(jnp.bfloat16))

    want = np.asarray(jax.jit(jax_stem)(jnp.asarray(img)).astype(jnp.float32))
    q = s.tq
    got = torch.relu(TQ._max_pool(TQ.stem_conv_bf16(torch.from_numpy(img), q.stem_w, 2, 3))
                     + q.stem_b.to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), want)

    h = torch.from_numpy(_x((2, 7, 9, 32), seed=5) * 3).to(torch.bfloat16)
    want = np.asarray(jax.jit(lambda h: jax.lax.reduce_window(
        h, jnp.bfloat16(0.0), jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1),
        ((0, 0),) * 4) * 0.25)(jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(TQ.avg_pool2_bf16(h).float().numpy(),
                                  np.asarray(want.astype(np.float32)))


def _jax_features(jq, x) -> np.ndarray:
    """JAX's ``apply``; a DenseNet's forward compiled with
    ``xla_allow_excess_precision`` off (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    if not hasattr(jq, "final_bn"):
        return np.asarray(jq.apply(jnp.asarray(x)))
    statics, tree = jq.split()
    compiled = jax.jit(jq.unjitted_forward(), static_argnums=(0,)).lower(
        statics, tree, jnp.asarray(x)).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(tree, jnp.asarray(x)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_carried_across_matches_jax_apply(arch):
    """The port's quantized featurizer carried across from JAX's, on the
    calibration images and on other images: within 1e-2 of max|JAX|, every
    row's cosine >= 0.9999. Beside it, the port's own quantized featurizer
    against the f32 model at JAX's gates (``tests/test_quantize.py``)."""
    s = _setup(arch)
    carried = _carry(s.jq)
    for x in (s.x, _x(s.x.shape, seed=9)):
        got, want = _feats(carried, x), _jax_features(s.jq, x)
        assert got.shape == want.shape == (x.shape[0], s.net.feat_dim) and np.isfinite(got).all()
        print(f"{arch} carried across vs JAX: rel {_rel_err(got, want):.2e}, "
              f"{np.mean(got == want):.4f} of elements bit-equal")
        assert _rel_err(got, want) <= REL and _min_cos(got, want) >= 0.9999


@pytest.mark.parametrize("head_precision", ["f32", "int8"])
def test_quantized_slice_matches_jax(head_precision):
    """``NWNet.quantize_featurizer`` + ``precompute`` + the serving function
    against JAX's ``NWNet`` on the same resnet10 weights, the bank and the
    queries through the int8 featurizer."""
    import jax
    import jax.numpy as jnp

    from nwhead_tpu.data.datasets import make_synthetic_dataset as jax_make_synthetic
    from nwhead_tpu.models import load_model as jax_load_model
    from nwhead_tpu.nw.net import NWNet as JaxNWNet
    from nwhead_tpu_torch.data.datasets import make_synthetic_dataset
    from nwhead_tpu_torch.models.convert import jax_to_torch_nwmodel
    from nwhead_tpu_torch.nw.net import NWNet

    train = jax_make_synthetic(n=64, n_classes=4, size=32, seed=0)
    val = jax_make_synthetic(n=32, n_classes=4, size=32, seed=1)
    jnet = JaxNWNet(jax_load_model("resnet10"), 4, support_dataset=train, feat_dim=512,
                    fused_min_support=1, head_precision=head_precision)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(train.gather(np.arange(4)))))
    calib = train.gather(np.arange(32))
    jnet.quantize_featurizer(variables, calib)
    jnet.precompute(variables)
    x = val.gather(np.arange(16))
    want = np.exp(np.asarray(jnet.predict(variables, jnp.asarray(x), "full")))

    tnet = NWNet(load_model("resnet10", device="cpu"), 4,
                 support_dataset=make_synthetic_dataset(n=64, n_classes=4, size=32, seed=0),
                 device="cpu", feat_dim=512, fused_min_support=1, head_precision=head_precision)
    tnet.model.load_state_dict(jax_to_torch_nwmodel(variables))
    tnet.quantize_featurizer(calib)
    assert isinstance(tnet.serving_featurizer, TQ.QuantizedResNet) and tnet._prepared_full is None
    tnet.precompute()
    got = torch.exp(tnet.make_serving_fn()(x)).numpy()
    assert got.shape == (16, 4) and np.isfinite(got).all()
    print(f"int8 resnet10 slice ({head_precision} head) vs JAX: max|dp| "
          f"{np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    with torch.inference_mode():
        served = tnet._featurize_eval(torch.from_numpy(x))
        float_feats = tnet.model.featurize(torch.from_numpy(x))
    assert not torch.equal(served, float_feats)


def _vit_pair():
    """JAX's quantized small ViT (``tests/test_torch_quant_vit.py``'s) and
    its images."""
    from nwhead_tpu.models.quantize import quantize_vit as jax_quantize_vit
    from nwhead_tpu_torch.models.quantize import quantize_vit
    from test_torch_quant_vit import _images, _jax_vit

    model, variables, tmodel = _jax_vit()
    calib = _images(16, seed=3)
    return (jax_quantize_vit(model, variables, calib, calib_batch=8),
            quantize_vit(tmodel, calib, calib_batch=8), _images(4, seed=4))


def _family(family):
    """(JAX's quantized featurizer, the port's own, images) of a family."""
    if family == "vit":
        return _vit_pair()
    s = _setup({"resnet": "resnet10", "densenet": "densenet121"}[family])
    return s.jq, s.tq, s.x


def _carry_any(jq):
    from nwhead_tpu_torch.models.convert import jax_to_torch_quantized_vit

    return jax_to_torch_quantized_vit(jq) if hasattr(jq, "patch_w") else _carry(jq)


FAMILIES = ["resnet", "densenet", "vit"]


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_artifact_loads_in_the_port(family, tmp_path):
    from nwhead_tpu.models.quantize import save_quantized as jax_save

    jq, _, x = _family(family)
    path = str(tmp_path / "jax.npz")
    jax_save(jq, path)
    loaded = TQ.load_quantized(path)
    assert type(loaded) is type(_carry_any(jq))
    np.testing.assert_array_equal(_feats(loaded, x), _feats(_carry_any(jq), x))


@pytest.mark.parametrize("family", FAMILIES)
def test_port_artifact_loads_in_jax(family, tmp_path):
    import jax.numpy as jnp

    from nwhead_tpu.models.quantize import load_quantized as jax_load

    jq, _, x = _family(family)
    path = str(tmp_path / "port.npz")
    TQ.save_quantized(_carry_any(jq), path)
    loaded = jax_load(path)
    assert type(loaded) is type(jq)
    np.testing.assert_array_equal(np.asarray(loaded.apply(jnp.asarray(x))),
                                  np.asarray(jq.apply(jnp.asarray(x))))


@pytest.mark.parametrize("family", FAMILIES)
def test_port_artifact_round_trip(family, tmp_path):
    _, tq, x = _family(family)
    path = str(tmp_path / "round_trip")  # the loader adds .npz, as numpy's savez does
    TQ.save_quantized(tq, path)
    loaded = TQ.load_quantized(path)
    np.testing.assert_array_equal(_feats(loaded, x), _feats(tq, x))
    if family != "vit":
        for a, b in zip(_convs(loaded), _convs(tq)):
            assert (a.act_scale, a.stride, a.padding, a.groups) == (
                b.act_scale, b.stride, b.padding, b.groups)
            assert torch.equal(a.w_gemm, b.w_gemm)


def test_serve_cli_serves_an_int8_resnet_on_cpu():
    from nwhead_tpu_torch import serve

    args = serve.parse_args(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
                             "--featurizer_precision", "int8", "--head_precision", "int8",
                             "--calib_images", "16", "--batch_size", "8", "--latency_bench",
                             "--bench_batches", "2"])
    train_ds, val_ds = serve.build_datasets(args)
    net = serve.build_server(args, train_ds)
    assert isinstance(net.serving_featurizer, TQ.QuantizedResNet)
    assert net.calibration_seconds > 0 and net._prepared_full.s.dtype == torch.int8
    before = IC.int8_conv2d_cuda.launches
    report = serve.latency_bench(net, val_ds, args)
    assert report["batches"] == 2 and report["p50_ms"] > 0
    assert (report["arch"], report["featurizer_precision"]) == ("resnet10", "int8")
    assert IC.int8_conv2d_cuda.launches == before  # the plain version on the CPU


def test_eval_cli_runs_an_int8_resnet_on_cpu(capsys):
    from nwhead_tpu_torch import eval as eval_cli

    results = eval_cli.main(["--device", "cpu", "--dataset", "synthetic", "--arch", "resnet10",
                             "--modes", "full", "cluster", "--batch_size", "8",
                             "--num_val_steps", "2", "--n_shot_full", "5",
                             "--featurizer_precision", "int8", "--calib_images", "16"])
    assert "Quantized featurizer (int8 PTQ, 16 calibration images)" in capsys.readouterr().out
    for mode in ("full", "cluster"):
        assert np.isfinite(results[mode]["nll"]) and results[mode]["n"] == 16


# ---------------------------------------------------------------------------
# On the card: the CUDA route bit for bit against its plain version.
# ---------------------------------------------------------------------------

# (name, B, H, cin, cout, k, stride, padding, groups) at B=64
CUDA_CASES = [
    ("r50_1x1_64_256_56", 64, 56, 64, 256, 1, 1, 0, 1),
    ("r50_3x3_s2_128_28", 64, 56, 128, 128, 3, 2, 1, 1),
    ("r50_downsample_1x1_s2", 64, 56, 256, 512, 1, 2, 0, 1),
    ("rx50_grouped_32x4_56", 64, 56, 128, 128, 3, 1, 1, 32),
    ("d121_3x3_128_32_56", 64, 56, 128, 32, 3, 1, 1, 1),
    ("r50_layer4_3x3_512_7", 64, 7, 512, 512, 3, 1, 1, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_cuda_int8_conv2d_is_bit_equal_to_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, B, H, cin, cout, k, stride, padding, groups = case
    x8, wq = (torch.from_numpy(a).cuda() for a in _conv_operands(B, H, cin, cout, k, groups,
                                                                  "random", seed=1))
    before = IC.int8_conv2d_cuda.launches
    got = IC.int8_conv2d(x8, wq, stride, padding, groups)
    want = IC._int8_conv2d_plain(x8, wq, stride, padding, groups)
    torch.cuda.synchronize()
    assert IC.int8_conv2d_cuda.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
