"""The UNI2-h configuration's reference (``reference/vit_swiglu.py``): its
counts by hand, its weights named and shaped as the port's
``vit_from_config`` names and shapes them; and the readers of the
encoder's spans (``harness/encoder.py``) on made-up program windows."""

import copy
import json
from pathlib import Path

import pytest
import torch

from portbench.harness import manifest, program
from portbench.reference import kernels, vit_swiglu

ROOT = Path(__file__).resolve().parents[1]
UNI2H = json.loads((ROOT / "portbench" / "configs" / "uni_vit_uni2h.json").read_text())
TINY = copy.deepcopy(UNI2H)
TINY["model"].update(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2, reg_tokens=4)
TINY["extraction"].update(patch_size=48, stride=16, batch_size=4)


def test_uni2h_counts_by_hand():
    # 4 patches + the class token + 4 registers = 9 tokens; fc1 32 -> 170,
    # fc2 85 -> 32; resize 2*3*32*48*(48+32), embedding 2*4*(16*16*3)*32,
    # two blocks of 2*9*32*(96+32) + 2*9*(32*170 + 85*32) + 4*81*32
    block = 2 * 9 * 32 * 128 + 2 * 9 * (32 * 170 + 85 * 32) + 4 * 81 * 32
    assert vit_swiglu.patch_flops(TINY, 48) == 737280 + 196608 + 2 * block
    work = vit_swiglu.count(TINY, {"patches": [6, 9]})
    assert work["flops"] == 15 * vit_swiglu.patch_flops(TINY, 48)
    assert work["kernels"]["k3"] == [kernels.attention_fwd(4, 2, 9, 9, 16)] * (2 * (2 + 3))


def test_uni2h_at_its_published_widths():
    """265 tokens, fc1 1536 -> 8192, fc2 4096 -> 1536: 371.1 GFLOP a 256-px
    window, 3.01 times ViT-L/16's 123.3; 681.4 M parameters."""
    d, depth, heads, hd, hidden, reg, patches, tokens = vit_swiglu._dims(UNI2H)
    assert (d, depth, heads, hd, hidden, reg, patches, tokens) == \
        (1536, 24, 24, 64, 8192, 8, 256, 265)
    flops = vit_swiglu.patch_flops(UNI2H, 256)
    assert flops / 1e9 == pytest.approx(371.1, abs=0.05)
    vit_l = json.loads((ROOT / "portbench" / "configs" / "uni_vit_l16.json").read_text())
    from portbench.reference import vit
    assert flops / vit.patch_flops(vit_l, 256) == pytest.approx(3.01, abs=0.005)
    params = sum(torch.Size(shape).numel() for _, shape, *_ in vit_swiglu.weight_spec(UNI2H))
    assert params / 1e6 == pytest.approx(681.4, abs=0.05)


def test_the_weights_are_those_of_vit_from_config():
    from multimodal_fusion_tpu_torch.models.vit import vit_from_config

    model = vit_from_config(TINY["model"], torch.Generator().manual_seed(0))
    ours = {name: tuple(shape) for name, shape, *_ in vit_swiglu.weight_spec(TINY)}
    assert ours == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_the_reference_refuses_another_form():
    other = copy.deepcopy(TINY)
    other["model"]["mlp_layer"] = "gelu"
    with pytest.raises(ValueError):
        vit_swiglu.weight_spec(other)


def _window(counts, device_s):
    return program.Window(steps=1, seconds=2.0, records=[], counts=counts, device_s=device_s)


@pytest.mark.parametrize("metric,counts,device_s,want", [
    ("attention_ms.extract", {"vit.batches": 4, "vit.tokens": 100},
     {"vit.attention": 0.2, "vit.mlp": 0.4}, 50.0),
    ("mlp_ms.extract", {"vit.batches": 4, "vit.tokens": 100},
     {"vit.attention": 0.2, "vit.mlp": 0.4}, 100.0),
    ("mlp_ms.extract", {"vit.batches": 4, "vit.tokens": 100}, None, None),  # off the card
    ("attention_ms.extract", {"extract.cores": 2}, {"extract.core": 1.0}, None),  # no encoder spans
])
def test_the_encoder_readers(metric, counts, device_s, want, monkeypatch, capsys):
    cell = manifest.load_cell("uni_vit_uni2h.extract_cores")

    class _Run:
        pass

    run = _Run()
    run.cell, run.calls, run.units = cell, {"k3": 2 * 24}, 40
    monkeypatch.setattr(program, "_LAST", [run, _window(counts, device_s)])
    got = manifest.reader(metric)(run)
    assert got == (None if want is None else pytest.approx(want))
    err = capsys.readouterr().err
    if "vit.tokens" in counts:  # 100 tokens over 2 s, beside the padding of 64 rows, 40 real
        assert "50.0 tokens/s" in err and "pad_share.extract 37.5000%" in err
    else:
        assert "tokens/s" not in err
