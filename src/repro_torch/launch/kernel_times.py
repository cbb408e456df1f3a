"""Time the relational kernels three ways, at the shapes of ``chip_smoke.py``'s
kernel and ``wide_projection`` lines, on one NVIDIA GPU:

* ``events_ms``: CUDA events around one wrapper call, host work included
  (as ``chip_smoke.py`` reports ``kernel_ms``), median of ``--reps``;
* ``device_ms``: the device time of the kernels that call launches, from
  ``torch.profiler`` over ``--reps`` calls, per call; ``device_kernels``
  splits it by kernel (``None``, and ``device_ms_estimated`` in its place,
  where the trace lost launches: ``chip_smoke.device_ms``);
* ``host_ms``: the host time to enqueue one call (planning, allocation,
  launch), mean over ``--reps`` calls issued back to back;
* ``out_sha256``: the first 16 hex digits of the SHA-256 of the bytes of a
  call's output (a tensor, or a tuple of them, in order; else null), so
  that two checkouts' outputs can be compared bit for bit;
* ``bound_ms`` (the least time of the work on the card, from
  ``roofline.analysis``) and ``device_bound_share`` where the case has one.

The cases: at the path's 2 GiB table, the fused scan, the hash-join probe
in both forms, and the single projection, the filter, the multi-view
projection and the selection (50% kept), and BSL and PCK at the revision
study's ``A1,A5,A9,A13`` (``project_bsl``, ``project_pck``); at a record store of 4,096 training
samples of S 2,048 and 4,096 (``wide_projection``), the ``(tokens,
labels)`` view and its first 16 tokens through the projection
(``"mlp"``), the view through BSL and PCK (``project_bsl_s*`` and
``project_pck_s*``, their wide forms), and ``index_select`` of the same
words; the flash forward at
the serving shapes (``chip_smoke.FLASH_SHAPES``, no lse stored) and, where
the port has it, the flash backward at ``FLASH_BACKWARD_SHAPES`` (a
qwen3-8b training layer, then the CUDA-core form's shapes) and
``NARROW_BACKWARD_SHAPES`` (bf16 at D 64 and 32): the backward kernel's
one launch from a stored output and lse; beside each narrow shape
(``sdpa_backward_*``) the backward of one ``scaled_dot_product_attention``
call on the same inputs alone, its graph walked again and again (a
yardstick the port never calls); the RG-LRU scan's gradient at
``chip_smoke.RGLRU_SHAPE`` (``scan_backward_b8``) and at ``train_rg``'s
microbatch of B 2 (``scan_backward_b2``) through ``RGLRUScan.backward``
with the forward's saved ``a`` and ``h`` (so a parent checkout's backward
is timed the same way), and the scan's forward at B 2 and B 8
(``scan_forward_b2``, ``scan_forward_b8``; B 4 and 6 between them), also on inputs whose base is one
float past a 16-byte boundary (``scan_forward_b2_async``,
``scan_forward_b8_async``: the ``cp.async`` form, where the forward has
one).

    python3 src/repro_torch/launch/kernel_times.py [--src DIR] [--rows N] [--reps R]
        [--cases NAME,...]

``--src`` puts another checkout's ``src`` directory first on the path, so
one run of this script can measure two commits of the port the same way
(the tables come from ``chip_smoke.py`` of the checkout holding this
script); ``--cases`` keeps the cases whose name matches one of the
patterns given (``fnmatch``: ``project_s*,index_select_*``).  Prints one
JSON line per case.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
PATH_CASES = ("scan_multi", "hash_join", "hash_join_packed", "project", "filter_project",
              "project_multi", "select_compact", "project_bsl", "project_pck")
# the backward at narrower bf16 heads than the train layer's, beside
# FLASH_BACKWARD_SHAPES: seamless-m4t-medium's 16 / 16 heads of D 64 at
# S 2,048, causal (its decoder) and bidirectional (its encoder), and the
# train layer's heads at D 32
NARROW_BACKWARD_SHAPES = (
    ("flash_backward_d64", 2, 2048, 16, 16, 64, True, None, "bfloat16"),
    ("flash_backward_d64_bidirectional", 2, 2048, 16, 16, 64, False, None, "bfloat16"),
    ("flash_backward_d32", 2, 2048, 32, 8, 32, True, None, "bfloat16"))
# the RG-LRU scan: (name, B) at chip_smoke.RGLRU_SHAPE's S and W; an
# ``_async`` forward's a and x start one float past a 16-byte boundary
SCAN_CASES = (("scan_backward_b8", 8), ("scan_backward_b2", 2), ("scan_forward_b2", 2),
              ("scan_forward_b4", 4), ("scan_forward_b6", 6), ("scan_forward_b8", 8),
              ("scan_forward_b2_async", 2), ("scan_forward_b8_async", 8))


def host_ms(torch, fn, reps: int) -> float:
    """Mean host time to enqueue one call, ``reps`` calls back to back."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.mean(times)


def path_cases(torch, CS, K, rows):
    """The path's kernels over the 2 GiB table."""
    from repro_torch.core import TableGeometry

    table = CS.build_table(rows or CS.ROWS, 0, CS.BUILD_ROWS)
    dim = CS.build_dimension(CS.BUILD_ROWS, 0)
    words = torch.from_numpy(table.words()).cuda()
    n = words.shape[0]
    reqs = CS.path_requests(table, table.now())
    fused = [reqs[k] for k in ("project", "filter", "aggregate", "groupby", "aggregate2")]
    dw = dim.words()
    parts = K.build_partitions(dw[:, 1], dw[:, 2], dw[:, dim.ts_begin_word],
                               dw[:, dim.ts_end_word], device="cuda")
    packed = words[:, :2].contiguous()
    ts = table.now()
    p, f = reqs["project"], reqs["filter"]
    fkw = dict(pred_word=f.pred_word, pred_dtype=f.pred_dtype, pred_op=f.pred_op,
               pred_k=f.pred_k, ts=f.ts, ts_word=f.ts_word)
    geoms = [TableGeometry.from_schema(table.schema, v, n) for v in CS.MULTI_VIEWS]
    sel = TableGeometry.from_schema(table.schema, ["A1", "A9"], n)
    bsl = TableGeometry.from_schema(table.schema, CS.REVISION_VIEWS[4], n)
    skw = dict(pred_word=table.schema.word_offset("A3"), pred_op="gt",
               pred_k=dict(CS.SELECTIVITIES)[50], block_rows=CS.SELECT_BLOCK_ROWS)
    return [
        ("scan_multi", lambda: K.scan_multi(words, fused)),
        ("hash_join", lambda: K.hash_join(words, parts, 1, 0, 16, ts, True)),
        ("hash_join_packed", lambda: K.hash_join(packed, parts, 1, 0, -1, ts, True)),
        ("project", lambda: K.project(words, p.geom)),
        ("filter_project", lambda: K.filter_project(words, f.geom, **fkw)),
        ("project_multi", lambda: K.project_multi(words, geoms)),
        ("select_compact", lambda: K.select_compact(words, sel, **skw)),
        ("project_bsl", lambda: K.project(words, bsl, "bsl")),
        ("project_pck", lambda: K.project(words, bsl, "pck")),
    ]


def wide_names(CS, seq: int) -> list[str]:
    narrow = f"_w{CS.WIDE_NARROW}"
    return [f"{c}_s{seq}{x}" for x in ("", narrow) for c in ("project", "index_select")] + [
        f"project_bsl_s{seq}", f"project_pck_s{seq}"]


def wide_cases(torch, CS, K, keep):
    """The record stores' views, at each of ``CS.WIDE_SEQS`` that has a case
    ``keep`` takes; one store at a time is kept (yielded case by case)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import TableGeometry
    from repro_torch.kernels.common import geometry_words

    vocab = get_config(CS.TRAIN_ARCH).vocab
    for seq in CS.WIDE_SEQS:
        if not any(keep(name) for name in wide_names(CS, seq)):
            continue
        store = CS.record_store(torch, seq, CS.TRAIN_SAMPLES, vocab)
        words = store.engine.device_words(store.table)
        view = store.project(("tokens", "labels")).geometry
        narrow = TableGeometry(view.row_bytes, view.row_count, (4 * CS.WIDE_NARROW,),
                               (store.schema.byte_offset("tokens"),))
        for suffix, geom in (("", view), (f"_w{CS.WIDE_NARROW}", narrow)):
            idx = torch.tensor(geometry_words(geom), dtype=torch.long, device="cuda")
            want = K.project_torch(words, geom)
            yield f"project_s{seq}{suffix}", lambda g=geom: K.project(words, g), want
            yield f"index_select_s{seq}{suffix}", lambda i=idx: words.index_select(1, i), want
            if not suffix:
                yield f"project_bsl_s{seq}", lambda g=geom: K.project(words, g, "bsl"), want
                yield f"project_pck_s{seq}", lambda g=geom: K.project(words, g, "pck"), want
        del store, words
        gc.collect()
        torch.cuda.empty_cache()


def digest(out) -> str | None:
    """The first 16 hex digits of the SHA-256 of ``out``'s bytes (a tensor or
    a tuple of tensors), else None."""
    import hashlib

    import torch

    parts = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(t, torch.Tensor) for t in parts):
        return None
    h = hashlib.sha256()
    for t in parts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def flash_cases(torch, CS, keep):
    """The flash forward at the serving shapes and the backward at the train
    layer's, the CUDA-core form's and the narrow heads' (where the port
    under ``--src`` has one), inputs of each shape's type (bf16 for the
    forward) from a fixed seed, each with its bound; beside each narrow
    shape, SDPA's backward alone.  One shape's tensors at a time are kept."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import _cuda
    from repro_torch.roofline import analysis as A

    g = torch.Generator(device="cuda").manual_seed(9)
    backward = hasattr(_cuda, "run_flash_backward")
    shapes = [(False, *x, "bfloat16") for x in CS.FLASH_SHAPES]
    shapes += ([(True, *x) for x in CS.FLASH_BACKWARD_SHAPES + NARROW_BACKWARD_SHAPES]
               if backward else [])
    narrow = {x[0] for x in NARROW_BACKWARD_SHAPES}
    for grad, name, b, s, h, kh, d, causal, window, dtype in shapes:
        library = f"sdpa_backward{name[len('flash_backward'):]}" if name in narrow else None
        if not (keep(name) or (library and keep(library))):
            continue
        q, k, v, dout = (torch.randn((b, s, n, d), generator=g, device="cuda",
                                     dtype=getattr(torch, dtype)) for n in (h, kh, kh, h))
        bound = CS.flash_bound(b, s, h, kh, d, causal, window, q.element_size())[0]
        if grad:
            out, lse = _cuda.run_flash(q, k, v, causal, window, lse=True)
            if keep(name):
                yield (name, lambda: _cuda.run_flash_backward(q, k, v, out, lse, dout, causal,
                                                              window),
                       A.FLASH_BACKWARD_OPS * bound)
            del out, lse
            if library and keep(library):
                assert window is None, name
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                lib_out = Fn.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in leaves), is_causal=causal,
                    enable_gqa=True).transpose(1, 2)
                yield (library, lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                            retain_graph=True),
                       A.FLASH_BACKWARD_OPS * bound)
                del leaves, lib_out
        else:
            yield name, lambda: _cuda.run_flash(q, k, v, causal, window), bound
        del q, k, v, dout
        torch.cuda.empty_cache()


def scan_cases(torch, CS, keep):
    """The RG-LRU scan's gradient and forward (``SCAN_CASES``), ``a`` in
    (0, 1), ``x`` and ``dh`` normal from a fixed seed, each with its bound
    by bytes; the gradient through ``RGLRUScan.backward`` on a context
    holding the forward's saved ``a`` and ``h``; an ``_async`` forward's
    inputs copied one float past a 16-byte boundary, its output held against
    the plain loop before it is timed."""
    import types

    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.roofline import analysis as A

    _, s, w = CS.RGLRU_SHAPE
    for name, b in SCAN_CASES:
        if not keep(name):
            continue
        g = torch.Generator(device="cuda").manual_seed(29)
        a = torch.rand((b, s, w), generator=g, device="cuda").clamp_(min=1e-6)
        x, dh = (torch.randn((b, s, w), generator=g, device="cuda") for _ in range(2))
        if name.endswith("_async"):
            want = RS.rglru_scan_torch(a, x)
            a, x = (torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape).copy_(t)
                    for t in (a, x))
            assert torch.equal(RS.rglru_scan(a, x), want), name
            del want
        if name.startswith("scan_forward"):
            yield (name, lambda: RS.rglru_scan(a, x),
                   A.rglru_scan_work(b, s, w)[1] / CS.hw().hbm_bw * 1e3)
        else:
            ctx = types.SimpleNamespace(saved_tensors=(a, RS.rglru_scan(a, x)))
            yield (name, lambda: RS.RGLRUScan.backward(ctx, dh),
                   A.rglru_scan_backward_work(b, s, w)[1] / CS.hw().hbm_bw * 1e3)
            del ctx
        del a, x, dh
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="")
    ap.add_argument("--cases", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import ops as K

    import repro_torch

    wanted = tuple(c for c in args.cases.split(",") if c)
    keep = lambda name: not wanted or any(fnmatch.fnmatch(name, c) for c in wanted)  # noqa: E731

    def report(name, fn, want=None, bound_ms=None):
        got = fn()
        torch.cuda.synchronize()
        if want is not None:  # held against the plain version before it is timed
            assert torch.equal(got, want), name
        sha = digest(got)
        del got
        line = {
            "case": name, "tag": args.tag, "package": str(Path(repro_torch.__file__).parent),
            "device": torch.cuda.get_device_name(0),
            "events_ms": CS.time_ms(torch, fn, args.reps),
            **CS.device_fields(torch, fn, args.reps),
            "host_ms": host_ms(torch, fn, args.reps),
            "out_sha256": sha,
        }
        if bound_ms is not None:
            line["bound_ms"] = bound_ms
            if line["device_ms"]:
                line["device_bound_share"] = bound_ms / line["device_ms"]
        print(json.dumps(line), flush=True)

    if any(keep(name) for name in PATH_CASES):
        for name, fn in path_cases(torch, CS, K, args.rows):
            if keep(name):
                report(name, fn)
    for name, fn, want in wide_cases(torch, CS, K, keep):
        if keep(name):
            report(name, fn, want)
    for name, fn, bound_ms in flash_cases(torch, CS, keep):
        report(name, fn, bound_ms=bound_ms)
    for name, fn, bound_ms in scan_cases(torch, CS, keep):
        report(name, fn, bound_ms=bound_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
