"""The frozen arithmetic equals the program's own at the cells' shapes: the
sector bound (``chip_smoke.bound``), the train step's model operations
(``chip_smoke.train_model_flops``), the flash work
(``roofline.analysis``) and the card's peaks."""

import importlib.util
import json
from pathlib import Path

import pytest

from rmbench.work import flash, flops, peaks, sectors

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config(name: str) -> dict:
    return json.loads((ROOT / "rmbench" / "configs" / f"{name}.json").read_text())


def _requests(ts: int):
    from repro_torch.core import RelationalMemoryEngine, RelationalTable, benchmark_schema
    from repro_torch.core.requests import AggregateOp, FilterOp, GroupByOp, ProjectOp

    schema = benchmark_schema(64, 4)
    table = RelationalTable.from_columns(schema, {c.name: [1, 2, 3] for c in schema.columns})
    eng = RelationalMemoryEngine(device="cpu")
    return [
        ProjectOp(eng.register(table, ["A1", "A5", "A9", "A13"])).lower(),
        FilterOp(eng.register(table, ["A2", "A3", "A7", "A16"]), "A4", "gt", 0, ts).lower(),
        FilterOp(eng.register(table, ["A8"]), "A8", "none", 0, ts).lower(),
        AggregateOp(table, "A6", "A7", "lt", 100, ts).lower(),
        AggregateOp(table, "A9", snapshot_ts=ts).lower(),
        GroupByOp(table, "A16", "A8", 16, pred_col="A3", pred_op="gt", pred_k=0,
                  snapshot_ts=ts).lower(),
    ]


def _program_bound(smoke, reqs, rows, row_bytes) -> float:
    from repro_torch.kernels import rme_scan_multi as KR

    def touched(req):
        return {o // 4 + j for o, w in KR.request_intervals(req) for j in range(w // 4)}

    def out_bytes(req):
        if isinstance(req, KR.ProjectRequest):
            return rows * req.geom.out_bytes_per_row
        if isinstance(req, KR.FilterRequest):
            return rows * (req.geom.out_bytes_per_row + 1)
        return KR.reduced_result_bytes(req)

    read = set().union(*(touched(r) for r in reqs))
    ms, _ = smoke.bound(read, sum(out_bytes(r) for r in reqs), rows, row_bytes,
                        smoke.OPS_PER_ROW * len(reqs))
    return ms / 1e3


@pytest.mark.parametrize("which", ["each", "fused"])
def test_sector_bound_is_the_programs(smoke, which):
    cfg = config("rm_paper_s")
    row_bytes = cfg["row_bytes"] + 8  # the two MVCC words
    reqs = _requests(ts=5)
    groups = [[r] for r in reqs] if which == "each" else [reqs, reqs[1:4]]
    for group in groups:
        got, moved = sectors.pass_bound_s(group, cfg["rows"], row_bytes)
        assert got == pytest.approx(_program_bound(smoke, group, cfg["rows"], row_bytes),
                                    rel=1e-12)
        assert moved >= cfg["rows"] * 4 * min(len(sectors.request_words(r)) for r in group)


def test_sector_bytes_is_the_programs(smoke):
    for words in ({0}, {0, 1, 2, 3}, {3, 9, 16, 17}, set(range(18))):
        for rows in (1, 7, 1000, 2 ** 26):
            assert sectors.sector_bytes(words, rows, 72) == smoke.sector_bytes(words, rows, 72)


def test_train_flops_are_the_programs(smoke):
    from rmbench.drivers.train import port_config

    m = config("qwen3-8b-l8")
    mix = json.loads((ROOT / "rmbench" / "mixes" / "train.json").read_text())
    cfg = port_config(m, mix["microbatches"])
    tokens = mix["batch"] * mix["seq"]
    assert flops.param_count(m["num_hidden_layers"], m["hidden_size"],
                             m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"],
                             m["intermediate_size"], m["vocab_size"], True) == cfg.param_count()
    assert flops.train_step_flops(
        m["num_hidden_layers"], m["hidden_size"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"], m["intermediate_size"], m["vocab_size"], True,
        tokens, mix["seq"]) == smoke.train_model_flops(cfg, tokens, mix["seq"])


def test_flash_work_and_peaks_are_the_programs():
    from repro_torch.roofline import analysis

    for shape in ((2, 2048, 32, 8, 128), (1, 200, 16, 1, 128), (2, 256, 8, 2, 64)):
        assert flash.forward_work(*shape, 2) == analysis.flash_work(*shape, True, None, 2)
        assert flash.backward_work(*shape, 2) == analysis.flash_backward_work(*shape, True,
                                                                              None, 2)
    assert (peaks.BF16_FLOPS, peaks.FP32_FLOPS, peaks.HBM_BYTES_PER_S) == (
        analysis.HW.peak_flops, analysis.HW.fp32_flops, analysis.HW.hbm_bw)
