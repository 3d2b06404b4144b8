"""UNI2-h (a 1536-wide ViT/14 with a packed SwiGLU MLP and register tokens)
through the port's ViT and extraction path, against the plain reference
``tests/plain_vit_swiglu.py`` on the CPU, at tiny sizes.

Both sides get the same weights: a timm state dict, either drawn here or
converted from the port's seeded model.  LayerScale is drawn in [0.1, 0.5]:
UNI2-h's 1e-5 would leave the blocks ~1e-5 of the residual stream, below
what the tolerance can see.  Tolerance: relative L2 of each feature row
<= 1e-5 in float32.  The two sides sum in another order (the reference's
convolution against the port's Linear over HWC patch vectors, its one-shot
softmax against K3's plain online softmax over key chunks, its einsum
resize against the port's matrices), a few ulps (~1e-7) an operation over
two blocks; a wrong half of fc1, a token out of place or a missing
position row moves a row by 1e-2 or more.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_fusion_tpu_torch.data import tma_extraction as ttma
from multimodal_fusion_tpu_torch.models import vit as tvit
from multimodal_fusion_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parent))
import plain_vit_swiglu as plain  # noqa: E402

HEADS = 4
TINY = dict(img_size=28, patch_size=14, embed_dim=48, depth=2, num_heads=HEADS,
            mlp_ratio=2.66667 * 2, mlp="swiglu_packed", reg_tokens=4, no_embed_class=True)
HIDDEN = int(48 * 2.66667 * 2)  # 256: fc1 48 -> 256, fc2 128 -> 48
TOL = 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)).max())


def _tiny_port(seed=0, **changes):
    """The port's tiny UNI2-h form, seeded, LayerScale drawn in [0.1, 0.5]."""
    g = torch.Generator().manual_seed(seed)
    model = tvit.ViT(**dict(TINY, **changes), generator=g)
    with torch.no_grad():
        for blk in model.blocks:
            blk.ls1.uniform_(0.1, 0.5, generator=g)
            blk.ls2.uniform_(0.1, 0.5, generator=g)
    return model.eval()


def _timm_from_port(model):
    """The port's weights under timm's names and shapes."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    d, p = model.embed_dim, model.patch_size
    w = sd["patch_proj.weight"].reshape(d, p, p, 3).transpose(0, 3, 1, 2)  # HWC -> CHW
    out = {"patch_embed.proj.weight": w, "patch_embed.proj.bias": sd["patch_proj.bias"],
           "cls_token": sd["cls_token"][None], "pos_embed": sd["pos_embed"][None],
           "norm.weight": sd["norm.weight"], "norm.bias": sd["norm.bias"]}
    if "reg_token" in sd:
        out["reg_token"] = sd["reg_token"][None]
    names = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(len(model.blocks)):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{theirs}.{leaf}"] = sd[f"blocks.{i}.{ours}.{leaf}"]
        out[f"blocks.{i}.ls1.gamma"] = sd[f"blocks.{i}.ls1"]
        out[f"blocks.{i}.ls2.gamma"] = sd[f"blocks.{i}.ls2"]
    return out


def _timm_state(rng, d=48, p=14, depth=2, reg=4, grid=2, hidden=HIDDEN):
    """A synthetic timm UNI2-h state dict: ``reg_token`` [1, R, D], a
    patch-only ``pos_embed``, a packed ``mlp.fc1`` [hidden, D]."""
    def normal(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    state = {
        "patch_embed.proj.weight": normal(d, 3, p, p, scale=0.05),
        "patch_embed.proj.bias": normal(d),
        "cls_token": normal(1, 1, d, scale=1.0),
        "reg_token": normal(1, reg, d, scale=1.0),
        "pos_embed": normal(1, grid * grid, d, scale=1.0),
        "norm.weight": 1.0 + normal(d),
        "norm.bias": normal(d),
    }
    for i in range(depth):
        b = f"blocks.{i}."
        for name, shape in [("norm1.bias", (d,)), ("attn.qkv.weight", (3 * d, d)),
                            ("attn.qkv.bias", (3 * d,)), ("attn.proj.weight", (d, d)),
                            ("attn.proj.bias", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (hidden, d)), ("mlp.fc1.bias", (hidden,)),
                            ("mlp.fc2.weight", (d, hidden // 2)), ("mlp.fc2.bias", (d,))]:
            state[b + name] = normal(*shape, scale=0.2)
        state[b + "norm1.weight"] = 1.0 + normal(d)
        state[b + "norm2.weight"] = 1.0 + normal(d)
        state[b + "ls1.gamma"] = rng.uniform(0.1, 0.5, d).astype(np.float32)
        state[b + "ls2.gamma"] = rng.uniform(0.1, 0.5, d).astype(np.float32)
    return state


def _images(n=5, size=28, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((n, size, size, 3)),
                           dtype=torch.float32)


def _windows(n=6, size=40, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_forward_matches_the_plain_reference():
    model = _tiny_port()
    imgs = _images()
    with torch.no_grad():
        got = model(imgs).numpy()
    want = plain.forward(_timm_from_port(model), HEADS, imgs).numpy()
    assert got.shape == (5, 48)
    assert _rel_l2(got, want) <= TOL


def test_extractor_on_raw_windows_matches_the_plain_reference():
    """``make_feature_extractor`` on uint8 40 x 40 windows (the device-side
    /255, bicubic resize to 28 and normalisation; 6 windows in batches of 4,
    the last padded) against the reference's whole pipeline."""
    model = _tiny_port(seed=3)
    windows = _windows()
    got = ttma.make_feature_extractor(model, 4, device="cpu")(list(windows))
    want = plain.features(_timm_from_port(model), HEADS, 28, torch.as_tensor(windows)).numpy()
    assert got.shape == (6, 48)
    assert _rel_l2(got, want) <= TOL


def test_swapping_the_halves_of_fc1_breaks_the_agreement():
    state = _timm_state(np.random.default_rng(4))
    imgs = _images(seed=5)
    want = plain.forward(state, HEADS, imgs).numpy()
    swapped = dict(state)
    for i in range(2):
        for leaf in ("weight", "bias"):
            key = f"blocks.{i}.mlp.fc1.{leaf}"
            a, b = np.split(state[key], 2, axis=0)
            swapped[key] = np.concatenate([b, a], axis=0)
    ok, bad = _tiny_port(), _tiny_port()
    tvit.load_timm_vit_weights(ok, state)
    tvit.load_timm_vit_weights(bad, swapped)
    with torch.no_grad():
        assert _rel_l2(ok(imgs).numpy(), want) <= TOL
        assert _rel_l2(bad(imgs).numpy(), want) > 1e-2


@pytest.mark.parametrize("img_size,patch_size,no_embed_class,rows", [
    (16, 16, True, 1),  # one patch and no class row: the row count alone reads 0 x 16
    (16, 16, False, 2),
    (224, 14, True, 256),
    (224, 14, False, 257),
    (32, 16, True, 4),
])
def test_input_size_comes_from_the_patch_grid(img_size, patch_size, no_embed_class, rows):
    model = tvit.ViT(img_size=img_size, patch_size=patch_size, embed_dim=8, depth=1, num_heads=2,
                     no_embed_class=no_embed_class, generator=torch.Generator().manual_seed(0))
    assert model.pos_embed.shape[0] == rows
    assert model.input_size == img_size


def test_load_timm_uni2h_weights_matches_the_reference_from_the_same_dict():
    state = _timm_state(np.random.default_rng(6))
    model = _tiny_port(seed=7)
    n = tvit.load_timm_vit_weights(model, state)
    assert n == len(state)  # every tensor: 7 outside the blocks, 14 a block
    assert n == 7 + 2 * 14
    imgs = _images(seed=8)
    with torch.no_grad():
        got = model(imgs).numpy()
    assert _rel_l2(got, plain.forward(state, HEADS, imgs).numpy()) <= TOL
    # timm's [1, R, D] register tokens and [1, N, D] patch-only positions
    assert torch.equal(model.reg_token, torch.as_tensor(state["reg_token"][0]))
    assert torch.equal(model.pos_embed, torch.as_tensor(state["pos_embed"][0]))
    # a model without registers refuses a dict with them
    with pytest.raises(ValueError, match="register tokens"):
        tvit.load_timm_vit_weights(_tiny_port(reg_tokens=0), state)


def test_vit_from_config_builds_uni2h_and_uni():
    small = dict(tvit.UNI2_H, img_size=28, embed_dim=48, depth=1, num_heads=4)
    model = tvit.vit_from_config(small, torch.Generator().manual_seed(0))
    blk = model.blocks[0]
    assert blk.mlp == "swiglu_packed" and blk.head_dim == 12
    assert blk.fc1.weight.shape == (HIDDEN, 48) and blk.fc2.weight.shape == (48, HIDDEN // 2)
    assert model.reg_token.shape == (8, 48) and model.pos_embed.shape == (4, 48)
    assert model.input_size == 28
    # UNI2-h's published widths: fc1 1536 -> 8192, fc2 4096 -> 1536
    assert int(tvit.UNI2_H["embed_dim"] * tvit.UNI2_H["mlp_ratio"]) == 8192
    uni = tvit.vit_from_config({"img_size": 32, "patch_size": 16, "embed_dim": 32, "depth": 1,
                                "num_heads": 2, "mlp_ratio": 4.0, "init_values": 1e-5,
                                "layer_norm_eps": 1e-6}, torch.Generator().manual_seed(0))
    assert uni.blocks[0].mlp == "gelu" and uni.reg_token is None and uni.pos_embed.shape[0] == 5
    # the same draws as the constructor with UNI's defaults
    ref = tvit.ViT(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                   generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(uni.state_dict().values(),
                                                  ref.state_dict().values()))
    for bad in ({"act_layer": "gelu"}, {"layer_norm_eps": 1e-5}, {"num_classes": 2},
                {"class_token": False}):
        with pytest.raises(ValueError):
            tvit.vit_from_config(dict(small, **bad), torch.Generator().manual_seed(0))


def test_spans_and_counters_of_a_forward():
    """Each block opens ``vit.attention`` then ``vit.mlp``; a forward counts
    one ``vit.batches`` and its rows times its tokens (1 class + 4 register
    + 4 patch tokens) in ``vit.tokens``; tracing changes no bit."""
    model = _tiny_port(seed=9)
    imgs = _images(n=3, seed=10)
    profiling.reset()
    with torch.no_grad():
        plain_out = model(imgs)
        with profiling.tracing():
            traced = model(imgs)
    assert torch.equal(plain_out, traced)
    names = [r[0] for r in profiling.records()]
    assert names == ["vit.attention", "vit.mlp"] * 2
    counts = profiling.counters()
    assert counts["vit.batches"] == 2 and counts["vit.tokens"] == 2 * 3 * (1 + 4 + 4)
    profiling.reset()


def test_cli_uni2h_on_png_cores(tmp_path, monkeypatch):
    """``--model uni2_h`` on PNG cores with --device cpu: 1536-wide rows
    under the model's own file name; the encoder is swapped for a one-block
    UNI2-h at its published width (the 24 blocks are too large for a CPU
    test)."""
    from PIL import Image

    from multimodal_fusion_tpu_torch.cli import extract_tma_features as cli

    rng = np.random.default_rng(11)
    (tmp_path / "in" / "cd3").mkdir(parents=True)
    Image.fromarray(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)).save(
        tmp_path / "in" / "cd3" / "core_a.png")
    Image.fromarray(rng.integers(0, 255, (20, 24, 3)).astype(np.uint8)).save(
        tmp_path / "in" / "cd3" / "core_b.png")
    built = []

    def tiny_uni2h(generator):
        built.append(generator)
        return tvit.vit_from_config(dict(tvit.UNI2_H, img_size=28, depth=1), generator)

    monkeypatch.setattr(cli, "vit_uni2_h", tiny_uni2h)
    written = cli.main(["--input_dir", str(tmp_path / "in"), "--output_dir",
                        str(tmp_path / "out"), "--markers", "cd3", "--model", "uni2_h",
                        "--patch_size", "32", "--stride", "16", "--batch_size", "4",
                        "--device", "cpu"])
    assert written == {"cd3": 2} and len(built) == 1
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["tma_uni2h_tile_1536_cd3.npz"]
    out = np.load(tmp_path / "out" / "tma_uni2h_tile_1536_cd3.npz")
    assert out["core_a"].shape == (2 * 3, 1536)  # 2 x 3 windows of 32 at stride 16
    assert out["core_b"].shape == (1, 1536)  # small core, resized whole
    assert np.isfinite(out["core_a"]).all()
