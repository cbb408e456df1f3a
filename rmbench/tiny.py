"""A benchmark directory at a size a CPU test can run: a copy of this one
with a small configuration and mix of each driver (and their cells) added
as new files and manifest entries, the way a later change adds a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from .manifest import BENCH_DIR

RM_TINY = {
    "name": "rm_tiny", "driver": "relational", "source": "arXiv:2109.14349 Sec. 6.2 (cut)",
    "rows": 4096, "columns": 16, "column_bytes": 4, "row_bytes": 64,
    "value_range": [-1000, 1000], "key_column": "A2", "key_range": 2048,
    "revision": "mlp", "setup_deletes": 64,
    "server": {"snapshot_reads": True, "pipeline": True, "lanes": True, "max_batch": 64},
    "limits": {"sum_err": 1e-05, "avg_err": 1e-05, "mismatches": 0},
}
QWEN_TINY = {
    "name": "qwen3-tiny", "driver": "train", "source": "https://huggingface.co/Qwen/Qwen3-8B",
    "port_arch": "qwen3-8b", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "num_hidden_layers": 2, "vocab_size": 256, "rope_theta": 1000000, "rms_norm_eps": 1e-06,
    "hidden_act": "silu", "attention_bias": False, "tie_word_embeddings": False,
    "compute_dtype": "bfloat16", "param_dtype": "float32",
    "optimizer": {"lr": 0.001, "beta1": 0.9, "beta2": 0.95, "eps": 1e-08, "weight_decay": 0.1,
                  "clip_norm": 1.0, "warmup_steps": 2, "decay_steps": 10000,
                  "min_lr_ratio": 0.1},
    # set from CPU readings over seeds 1-12 (program max / float8 control min /
    # half-batch min): loss 1.4e-4 / 4.5e-4 / 7.1e-3, gradient 1.5e-3 / 5.7e-3 /
    # 0.11, change 2.6e-3 / 4.4e-3 / 0.12
    "limits": {"batch_mismatch": 0, "loss_gap": 2.5e-4, "grad_gap": 3e-3, "change_gap": 1e-2},
}
TRAIN_TINY = {"driver": "train", "samples": 64, "seq": 32, "batch": 8, "microbatches": 4,
              "pipeline_seed": 0, "check_steps": 3, "profile_steps": 1}


def relational_mix(clients: int) -> dict:
    mix = json.loads((BENCH_DIR / "mixes" / "scan_mix.json").read_text())
    mix.update(clients=clients, warmup_rounds=2, profile_seconds=0.2,
               check={"blocked_share": 0.05, "max_blocked": 6, "small_share": 0.2,
                      "max_small": 50})
    return mix


def make(dest: Path) -> Path:
    """Copy the benchmark to ``dest / "rmbench"`` with the small cells
    ``rm_tiny.scan_mix_tiny``, ``rm_tiny.single_tiny`` and
    ``qwen3-tiny.train_tiny`` (and the program linked as ``dest / "src"``);
    returns the copy's directory."""
    bench = Path(dest) / "rmbench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for cfg in (RM_TINY, QWEN_TINY):
        (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        manifest["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                    "file": f"rmbench/configs/{cfg['name']}.json",
                                    "reduced": [], "why": "a size a CPU test can run"})
    for name, mix in (("scan_mix_tiny", relational_mix(4)), ("single_tiny", relational_mix(1)),
                      ("train_tiny", TRAIN_TINY)):
        (bench / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    cells = {"rm_tiny.scan_mix_tiny": ("rm_tiny", "scan_mix_tiny"),
             "rm_tiny.single_tiny": ("rm_tiny", "single_tiny"),
             "qwen3-tiny.train_tiny": ("qwen3-tiny", "train_tiny")}
    for cell, (config, traffic) in cells.items():
        manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                      "chips": 1, "why": "a size a CPU test can run"})
    tiny_of = {"rm_paper_s.scan_mix": "rm_tiny.scan_mix_tiny",
               "rm_paper_s.single_client": "rm_tiny.single_tiny",
               "qwen3-8b-l8.train": "qwen3-tiny.train_tiny"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [tiny_of[c] for c in m["workloads"] if c in tiny_of]
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    (bench.parent / "src").symlink_to(BENCH_DIR.parent / "src")
    return bench
