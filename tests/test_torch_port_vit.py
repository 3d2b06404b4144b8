"""The port's ViT feature-extraction path against the JAX package on the CPU.

Both sides get the same weights: the JAX ViT's parameters flattened and
converted by ``vit_params_from_jax``.  Inputs come from numpy seeds.
Tolerances: resizing within 1e-5 (the weight matrices agree to an ulp;
the products sum in another order); forwards within 1e-5 (float32 sums in
another order); the extractors within 1e-4 relative (preprocessing adds
its own rounding);
Lanczos upsampling plus round-and-clip within +-1 on at most 0.1% of the
pixels (a value near .5 may round either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu.data import tma_extraction as jtma
from multimodal_fusion_tpu.models import vit as jvit
from multimodal_fusion_tpu_torch.data import tma_extraction as ttma
from multimodal_fusion_tpu_torch.models import vit as tvit
from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_fwd
from multimodal_fusion_tpu_torch.ops.resize import resize

TINY = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4)


def _flat_params(model):
    return {path: np.asarray(v[...]) for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _pair(patch_size=16, seed=0):
    """A tiny JAX ViT and the port's ViT carrying the same weights, at
    LayerScale 1: UNI's 1e-5 would leave the blocks ~1e-5 of the residual
    stream, below what the tolerances can see."""
    cfg = dict(TINY, patch_size=patch_size, init_values=1.0)
    jax_model = jvit.ViT(**cfg, rngs=nnx.Rngs(seed))
    port = tvit.ViT(**cfg, generator=torch.Generator().manual_seed(seed))
    port.load_state_dict(tvit.vit_params_from_jax(_flat_params(jax_model)))
    return jax_model, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("src,dst", [(256, 224), (48, 32), (20, 33)])
def test_bicubic_resize_matches_jax(src, dst):
    img = np.random.default_rng(src).random((src, src + 3, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (dst, dst, 3), method="bicubic"))
    got = resize(torch.as_tensor(img), (dst, dst), "bicubic").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # batched, as the raw path runs it on the device
    got_b = resize(torch.as_tensor(np.stack([img, img])), (dst, dst), "bicubic").numpy()
    np.testing.assert_allclose(got_b[1], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(100, 90, 3), (20, 20, 3), (255, 300, 3)])
def test_small_core_lanczos_matches_jax(shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(np.uint8)
    want = jtma.extract_patches_from_image(img, 256, 128)
    got = ttma.extract_patches_from_image(img, 256, 128)
    assert len(got) == len(want) == 1
    assert got[0].dtype == np.uint8 and got[0].shape == (256, 256, 3)
    diff = np.abs(got[0].astype(np.int16) - want[0].astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_patch_extraction_and_white_filter_match_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 200, (512, 640, 3)).astype(np.uint8)
    img[:300, :300] = 255
    for kw in ({}, dict(white_threshold=0.9, min_content_ratio=0.5)):
        want = jtma.extract_patches_from_image(img, 256, 128, **kw)
        got = ttma.extract_patches_from_image(img, 256, 128, **kw)
        assert len(got) == len(want) and len(got) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert ttma.is_patch_valid(np.full((8, 8, 3), 120, np.uint8), 0.9, 0.3)
    assert not ttma.is_patch_valid(np.full((8, 8, 3), 255, np.uint8), 0.9, 0.3)


def test_patchify_order(pair):
    _, port = pair
    img = torch.arange(2 * 32 * 32 * 3, dtype=torch.float32).reshape(2, 32, 32, 3)
    patches = port.patchify(img)
    assert patches.shape == (2, 4, 16 * 16 * 3)
    # first patch is the top-left block in HWC order, the second its right neighbour
    assert torch.equal(patches[1, 0], img[1, :16, :16].reshape(-1))
    assert torch.equal(patches[1, 1], img[1, :16, 16:].reshape(-1))
    jax_model, _ = pair
    want = np.asarray(jax_model.patchify(jnp.asarray(img[0].numpy())))
    np.testing.assert_array_equal(port.patchify(img[0]).numpy(), want)


@pytest.mark.parametrize("patch_size", [8, 16])
@pytest.mark.parametrize("impls", [("pallas_interpret", "auto"), ("xla", "xla")])
def test_vit_forward_matches_jax(patch_size, impls):
    jax_impl, port_impl = impls
    jax_model, port = _pair(patch_size, seed=patch_size)
    jvit.set_attention_impl(jax_model, jax_impl)
    tvit.set_attention_impl(port, port_impl)
    imgs = np.random.default_rng(9).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = np.stack([np.asarray(jax_model(jnp.asarray(x))) for x in imgs])
    with torch.no_grad():
        got = port(torch.as_tensor(imgs)).numpy()
        one = port(torch.as_tensor(imgs[1])).numpy()
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(one, want[1], rtol=1e-5, atol=1e-5)


def test_vit_params_from_jax_maps_every_parameter(pair):
    jax_model, port = pair
    flat = _flat_params(jax_model)
    sd = tvit.vit_params_from_jax(flat)
    assert set(sd) == set(port.state_dict())
    np.testing.assert_array_equal(sd["blocks.1.qkv.weight"].numpy(),
                                  flat[("blocks", 1, "qkv", "kernel")].T)
    np.testing.assert_array_equal(sd["norm.weight"].numpy(), flat[("norm", "scale")])
    # dotted string paths work as well
    dotted = {".".join(map(str, k)): v for k, v in flat.items()}
    assert all(torch.equal(sd[k], v) for k, v in tvit.vit_params_from_jax(dotted).items())


def _timm_state(rng, d=64, p=16, depth=2, n_tokens=5):
    state = {
        "patch_embed.proj.weight": rng.standard_normal((d, 3, p, p)).astype(np.float32) * 0.05,
        "patch_embed.proj.bias": rng.standard_normal(d).astype(np.float32) * 0.1,
        "cls_token": rng.standard_normal((1, 1, d)).astype(np.float32),
        "pos_embed": rng.standard_normal((1, n_tokens, d)).astype(np.float32),
        "norm.weight": 1.0 + 0.1 * rng.standard_normal(d).astype(np.float32),
        "norm.bias": 0.1 * rng.standard_normal(d).astype(np.float32),
    }
    for i in range(depth):
        pre = f"blocks.{i}."
        for name, shape in [("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
                            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (4 * d, d)), ("mlp.fc1.bias", (4 * d,)),
                            ("mlp.fc2.weight", (d, 4 * d)), ("mlp.fc2.bias", (d,)),
                            ("ls1.gamma", (d,)), ("ls2.gamma", (d,))]:
            state[pre + name] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return state


def test_load_timm_vit_weights_matches_jax():
    state = _timm_state(np.random.default_rng(0))
    jax_model = jvit.ViT(**TINY, rngs=nnx.Rngs(1))
    port = tvit.ViT(**TINY, generator=torch.Generator().manual_seed(1))
    n_jax = jvit.load_timm_vit_weights(jax_model, state)
    n_port = tvit.load_timm_vit_weights(port, state)
    assert n_port == n_jax == 6 + 2 * 14
    img = np.random.default_rng(2).standard_normal((32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_model(jnp.asarray(img)))
    with torch.no_grad():
        got = port(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the conv -> linear transpose: the first token is the conv of the first patch
    w = state["patch_embed.proj.weight"]
    want_tok = np.einsum("hwc,dchw->d", img[:16, :16], w) + state["patch_embed.proj.bias"]
    with torch.no_grad():
        tok = port.patch_proj(port.patchify(torch.as_tensor(img)))[0].numpy()
    np.testing.assert_allclose(tok, want_tok, rtol=1e-4, atol=1e-4)


def test_preprocess_patch_matches_jax():
    p = np.random.default_rng(0).integers(0, 255, (256, 256, 3)).astype(np.uint8)
    np.testing.assert_allclose(tvit.preprocess_patch(p), jvit.preprocess_patch(p), rtol=0, atol=5e-5)


@pytest.mark.parametrize("shape", [(32, 32, 3), (48, 48, 3)])
def test_raw_uint8_path_matches_host_preprocess(pair, shape):
    """Uniform uint8 patches ship raw and preprocess on the device; others
    preprocess on the host: both give the same features."""
    _, port = pair
    rng = np.random.default_rng(4)
    patches = [rng.integers(0, 255, shape).astype(np.uint8) for _ in range(5)]
    before = attention_fwd.launches
    raw = ttma.make_feature_extractor(port, batch_size=4, device="cpu")(patches)
    assert attention_fwd.launches == before  # the CPU runs K3's plain version
    pre = np.stack([tvit.preprocess_patch(p, size=32) for p in patches])
    with torch.no_grad():
        host = port(torch.as_tensor(pre)).numpy()
    np.testing.assert_allclose(raw, host, rtol=2e-4, atol=2e-5)
    # a non-uniform list takes the host path
    mixed = ttma.make_feature_extractor(port, batch_size=4, device="cpu")(
        patches[:2] + [patches[2].astype(np.float32)])
    np.testing.assert_allclose(mixed, host[:3], rtol=2e-4, atol=2e-5)


def test_raw_path_builds_resize_weights_once(pair, monkeypatch):
    """The bicubic matrices are built (a synchronous upload on the card)
    once per patch shape, not once per batch."""
    _, port = pair
    calls = []
    build = ttma.resize_weights
    monkeypatch.setattr(ttma, "resize_weights", lambda *a, **kw: calls.append(a[0]) or build(*a, **kw))
    rng = np.random.default_rng(6)
    extract = ttma.make_feature_extractor(port, batch_size=2, device="cpu")
    for shape in ((48, 48, 3), (48, 48, 3), (40, 40, 3)):
        extract([rng.integers(0, 255, shape).astype(np.uint8) for _ in range(5)])  # 3 batches
    assert calls == [(48, 48), (40, 40)]


def test_extractor_matches_jax_extractor(pair):
    jax_model, port = pair
    rng = np.random.default_rng(5)
    patches = [rng.integers(0, 255, (48, 48, 3)).astype(np.uint8) for _ in range(6)]
    want = jtma.make_feature_extractor(jax_model, batch_size=4, attn_impl="pallas_interpret")(patches)
    got = ttma.make_feature_extractor(port, batch_size=4, device="cpu")(patches)
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bf16_extraction_agrees_with_f32(pair):
    _, port = pair
    rng = np.random.default_rng(2)
    patches = [rng.integers(0, 255, (32, 32, 3)).astype(np.uint8) for _ in range(6)]
    f32 = ttma.make_feature_extractor(port, batch_size=4, device="cpu")(patches)
    bf16 = ttma.make_feature_extractor(port, batch_size=4, compute_dtype="bfloat16",
                                       device="cpu")(patches)
    assert bf16.dtype == np.float32 and bf16.shape == f32.shape
    assert next(port.parameters()).dtype == torch.float32  # the model is not cast in place
    cos = np.sum(f32 * bf16, axis=1) / (np.linalg.norm(f32, axis=1) * np.linalg.norm(bf16, axis=1))
    assert cos.min() >= 0.999, cos


def test_extract_marker_features_and_npz_match_jax(pair, tmp_path):
    jax_model, port = pair
    rng = np.random.default_rng(1)
    images = {
        "core_block1_x2_y3_patient007": rng.integers(0, 255, (32, 48, 3)).astype(np.uint8),
        "core_block1_x4_y5_patient008": rng.integers(0, 255, (20, 20, 3)).astype(np.uint8),
    }
    jax_extractor = jtma.make_feature_extractor(jax_model, batch_size=4)
    want = jtma.extract_marker_features(images, jax_extractor, patch_size=32, stride=16)
    got = ttma.extract_marker_features(
        images, ttma.make_feature_extractor(port, batch_size=4, device="cpu"),
        patch_size=32, stride=16)
    assert set(got) == set(want) == set(images)
    # the small core's Lanczos round-and-clip may leave a pixel 1 apart
    # (test_small_core_lanczos_matches_jax), which moves a LayerScale-1
    # feature by ~1e-3: the JAX encoder sees the port's pixels there
    small = "core_block1_x4_y5_patient008"
    port_patch = ttma.extract_patches_from_image(images[small], 32, 16)
    jax_patch = jtma.extract_patches_from_image(images[small], 32, 16)
    assert np.abs(port_patch[0].astype(np.int16) - jax_patch[0]).max() <= 1
    want[small] = jax_extractor(port_patch)
    for key in want:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5)
    jtma.save_marker_npz(tmp_path / "jax.npz", want)
    ttma.save_marker_npz(tmp_path / "port.npz", got)
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(a[k].shape == b[k].shape and b[k].dtype == np.float32 for k in a.files)


def test_mesh_is_not_ported_yet(pair, tmp_path):
    """The mesh is ported: in a gang of 2 each rank extracts its rows of a
    batch and the gathered features equal an unsharded run's (the JAX test
    test_mesh_sharded_extraction's claim)."""
    from multimodal_fusion_tpu_torch.parallel.multihost import run_gang

    results, _ = run_gang("multimodal_fusion_tpu_torch.parallel.dryrun:run_calls", 2, {"calls": [
        ("multimodal_fusion_tpu_torch.parallel.dryrun:check_extraction",
         dict(vit=TINY, n_patches=7, batch_size=4), {"data": 2})], "device": "cpu"},
        timeout=300, device="cpu", workdir=tmp_path)
    for (res,) in results:
        assert res["shape"] == [7, 64] and res["rel_l2"] <= 1e-5, res


def test_cli_on_png_cores(tmp_path, monkeypatch):
    """The CLI on PNG cores with --device cpu, the encoder swapped for a
    tiny ViT (ViT-L/16 is too large for a CPU test)."""
    from PIL import Image

    from multimodal_fusion_tpu_torch.cli import extract_tma_features as cli

    rng = np.random.default_rng(7)
    (tmp_path / "in" / "cd3").mkdir(parents=True)
    (tmp_path / "in" / "tma_tumorcenter_CD8").mkdir(parents=True)
    cores = {"cd3": {"core_block1_x2_y3_patient007": (64, 80), "core_block1_x1_y1_patient002": (20, 24)},
             "cd8": {"core_block2_x1_y1_patient003": (48, 48)}}
    for marker, items in cores.items():
        d = tmp_path / "in" / ("cd3" if marker == "cd3" else "tma_tumorcenter_CD8")
        for stem, (h, w) in items.items():
            Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(d / f"{stem}.png")
    monkeypatch.setattr(cli, "vit_large_16",
                        lambda generator: tvit.ViT(**TINY, generator=generator))
    written = cli.main(["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
                        "--markers", "cd3", "cd8", "he", "--patch_size", "32", "--stride", "16",
                        "--batch_size", "4", "--device", "cpu"])
    assert written == {"cd3": 2, "cd8": 1}
    out = np.load(tmp_path / "out" / "tma_uni_tile_1024_cd3.npz")
    assert sorted(out.files) == sorted(cores["cd3"])
    assert out["core_block1_x2_y3_patient007"].shape == (3 * 4, 64)  # 3 x 4 windows
    assert out["core_block1_x1_y1_patient002"].shape == (1, 64)  # small core, resized whole
    # --mesh_data larger than the world (no launcher) fails as JAX's make_mesh does
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        cli.main(["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
                  "--mesh_data", "2", "--device", "cpu"])


def test_torch_linear_fan_in_init_from_generator():
    from multimodal_fusion_tpu_torch.models.common import torch_linear

    a = torch_linear(256, 64, torch.Generator().manual_seed(3))
    b = torch_linear(256, 64, torch.Generator().manual_seed(3))
    c = torch_linear(256, 64, torch.Generator().manual_seed(4))
    assert a.weight.shape == (64, 256) and a.bias.shape == (64,)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert not torch.equal(a.weight, c.weight)
    bound = 1.0 / 16.0  # 1/sqrt(fan_in), torch.nn.Linear's default
    assert float(a.weight.abs().max()) <= bound and float(a.bias.abs().max()) <= bound
    # uniform on [-bound, bound]: variance bound^2 / 3
    assert abs(float(a.weight.var()) / (bound ** 2 / 3) - 1) < 0.05
