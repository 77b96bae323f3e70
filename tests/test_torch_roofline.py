"""repro_torch.launch.roofline against the reference's.

The same record (the reference's dry-run layout, which the port's dry run
writes too) goes through both ``roofline_row``s. The compute and the
collective terms are the reference's scaled by the ratio of the
constants (v5e → H100 SXM5). The memory term's dot bytes scale the same
way; its optimizer traffic and MODEL_FLOPS count the parameters of
``Model(cfg, "meta")`` where the reference counts ``cfg.param_count()``,
an approximation whose gap is pinned here (xlstm-125m: 36,740,400
parameters, its sLSTM and mLSTM blocks).
"""

import dataclasses
import json

import pytest

from repro.launch import roofline as ref_roofline
from repro_torch.configs.base import get_config, list_archs
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import roofline

RECORD = {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "16x16", "num_chips": 256,
          "ok": True, "memory": {"temp_bytes": None},
          "loop_aware": {"flops": 9.5e13, "dot_hbm_bytes": 4.1e12,
                         "collective_bytes": {"all-reduce": 1e10, "all-gather": 2e9},
                         "collective_counts": {"all-reduce": 100, "all-gather": 50},
                         "collective_total_bytes": 1.2e10}}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_terms_are_the_reference_s_scaled_by_the_constants(shape):
    rec = dict(RECORD, shape=shape)
    got, ref = roofline.roofline_row(rec), ref_roofline.roofline_row(rec)
    assert got["t_compute_s"] == pytest.approx(
        ref["t_compute_s"] * ref_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS, rel=1e-12)
    assert got["t_collective_s"] == pytest.approx(
        ref["t_collective_s"] * ref_roofline.ICI_BW / roofline.LINK_BW, rel=1e-12)
    cfg = get_config("gemma2-2b")
    opt = {"train": 30 * (roofline.param_count(cfg) - cfg.param_count()) / 256}.get(
        get_shape(shape).kind, 0.0)
    assert got["mem_bytes_per_chip"] == pytest.approx(ref["mem_bytes_per_chip"] + opt, rel=1e-12)
    assert got["t_memory_s"] == pytest.approx(got["mem_bytes_per_chip"] / 3.35e12, rel=1e-12)
    n = roofline.param_count(cfg)
    assert got["model_flops"] == pytest.approx(ref["model_flops"] * n / cfg.param_count(),
                                               rel=1e-12)
    for key in ("arch", "shape", "mesh", "chips", "flops_per_chip", "coll_bytes_per_chip",
                "temp_bytes"):
        assert got[key] == ref[key]
    assert set(got) == set(ref)


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert "v5e" not in roofline.__doc__


def test_meta_count_against_param_count():
    xl = get_config("xlstm-125m")
    assert roofline.param_count(xl) - xl.param_count() == 36_740_400
    assert roofline.param_count(xl) == 134_356_272
    # at a 2,048-token vocabulary (the size the card's xlstm training phase runs)
    assert roofline.param_count(dataclasses.replace(xl, vocab_size=2048)) == 97_295_664
    for arch in list_archs():
        cfg = get_config(arch)
        n = roofline.param_count(cfg)
        assert abs(n - cfg.param_count()) <= 0.4 * n, arch
        if cfg.moe_experts:
            assert roofline.param_count(cfg, active=True) == pytest.approx(
                cfg.active_param_count(), rel=1e-3)


def test_build_table_reads_ok_records_and_writes_nothing_by_default(tmp_path, capsys):
    (tmp_path / "gemma2-2b__train_4k__16x16.json").write_text(json.dumps(RECORD))
    (tmp_path / "minicpm-2b__train_4k__16x16.json").write_text(json.dumps(
        dict(RECORD, arch="minicpm-2b", ok=False, loop_aware=None)))
    table, rows = roofline.build_table(tmp_path)
    assert [r["arch"] for r in rows] == ["gemma2-2b"] and "gemma2-2b" in table
    roofline.main(["--dryrun-dir", str(tmp_path)])
    assert "| gemma2-2b | train_4k |" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "gemma2-2b__train_4k__16x16.json", "minicpm-2b__train_4k__16x16.json"]
