"""The frozen arithmetic against published figures and the port's
recorded bounds."""

from __future__ import annotations

import json

import pytest

from bench_cuda.counts import model_counts as mc
from bench_cuda.tests.tiny import ROOT


def _model(name):
    return json.loads((ROOT / "cfg" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("backbone, gmac", [("resnet18", 1.81),
                                            ("resnet50", 4.09)])
def test_resnet_macs_match_torchvision(backbone, gmac):
    # torchvision's published multiply-adds at 224 px, 1000 classes
    assert round(mc.resnet_macs(backbone, 224, classes=1000) / 1e9, 2) \
        == gmac


def _bound_ms(nbytes):
    return nbytes / mc.PEAK_HBM_BYTES * 1e3


@pytest.mark.parametrize("preset, rows, sites, dtype, fwd_ms, bwd_ms", [
    # PERF.md's kernel table: bounds of the sites of one step
    ("pr3", 128, 9, "float32", 0.1553, 0.2329),
    ("pr3", 128, 9, "bfloat16", 0.0776, 0.1164),
    ("pr4", 256, 33, "float32", 2.5000, 3.7500),
    ("pr4", 256, 33, "bfloat16", 1.2500, 1.8750),
])
def test_sbr_bytes_match_recorded_bounds(preset, rows, sites, dtype, fwd_ms,
                                         bwd_ms):
    m = dict(_model(preset), dtype=dtype)
    assert len(mc.sbr_sites(m, rows)) == sites
    need = mc.fused_bytes_per_step(m, rows)
    assert _bound_ms(need["scale_bias_relu"]) == pytest.approx(fwd_ms,
                                                               abs=6e-5)
    assert _bound_ms(need["scale_bias_relu_backward"]) == pytest.approx(
        bwd_ms, abs=6e-5)


def test_pr5_stem_site_matches_recorded_bound():
    m = _model("pr5")
    rows, c = mc.sbr_sites(m, 1024)[0]
    assert (rows, c) == (3072 * 64 * 64, 64)
    assert _bound_ms(2 * rows * c * 2) == pytest.approx(0.9616, abs=6e-5)
    assert _bound_ms(3 * rows * c * 2) == pytest.approx(1.4423, abs=6e-5)


@pytest.mark.parametrize("preset, rows, sites, dtype, bound_ms", [
    # PERF.md's kernel table: channel_stats bounds of the sites of a step
    ("pr3", 128, 20, "float32", 0.1240),
    ("pr3", 128, 20, "bfloat16", 0.0620),
    ("pr4", 256, 53, "float32", 3.3973),
    ("pr4", 256, 53, "bfloat16", 1.6987),
])
def test_channel_stats_bytes_match_recorded_bounds(preset, rows, sites,
                                                   dtype, bound_ms):
    m = dict(_model(preset), dtype=dtype)
    assert len(mc.bn_sites(m, rows)) == sites
    assert _bound_ms(mc.channel_stats_bytes_per_step(m, rows)) == \
        pytest.approx(bound_ms, abs=1e-4)


def test_pr5_channel_stats_sites():
    sites = mc.bn_sites(_model("pr5"), 1024)
    assert len(sites) == 40 and sites[0] == (3072 * 64 * 64, 64)
    assert _bound_ms(sites[0][0] * 64 * 2) == pytest.approx(0.4808,
                                                            abs=6e-5)


def test_train_flops_per_sample():
    # pr5: 6 frames of ResNet-18 at 128 px dominate, x3 for training
    pr5 = mc.train_flops_per_sample(_model("pr5"))
    frames = 6 * 3 * 2 * mc.resnet_macs("resnet18", 128)
    assert frames < pr5 < 1.01 * frames
    pr4 = mc.train_flops_per_sample(_model("pr4"))
    assert 6 * mc.resnet_macs("resnet50", 224) < pr4
