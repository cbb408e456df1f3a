"""The port's ``ServeSession`` against the JAX package's, on the CPU.

Both sessions serve ``qwen3-8b-smoke`` at float32 compute with the same
weights (the reference's, carried across by ``params_from_reference``): five
requests over two slots, ``max_new`` 4, so slots are reused across three
admissions.  Greedy decoding must give the same token lists, request by
request; a second run with an ``eos_id`` taken from the first run's output
must retire that request early, in both.  Then the launcher runs on the CPU.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.serve import Request, ServeSession  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N_REQUESTS, SLOTS, MAX_NEW, MAX_LEN = 5, 2, 4, 32


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_smoke("qwen3-8b"), compute_dtype="float32")
    tcfg = dataclasses.replace(tget_smoke("qwen3-8b"), compute_dtype="float32")
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DecoderLM(tcfg, device="cpu", seed=None)
    tmodel.load_state_dict(params_from_reference(tcfg, jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, 3 + 2 * i).astype(np.int32) for i in range(N_REQUESTS)]


def serve(models, eos_id: int = -1):
    """Token lists of both sessions, and the port session's last state."""
    jmodel, params, tmodel = models
    jsess = JSession(jmodel, params, batch_slots=SLOTS, max_len=MAX_LEN, eos_id=eos_id)
    tsess = ServeSession(tmodel, batch_slots=SLOTS, max_len=MAX_LEN, eos_id=eos_id)
    jreqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(prompts(tmodel.cfg.vocab))]
    treqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(prompts(tmodel.cfg.vocab))]
    for jr, tr in zip(jreqs, treqs):
        jsess.submit(jr)
        tsess.submit(tr)
    jsess.run_to_completion()
    tsess.run_to_completion()
    return [r.out for r in jreqs], [r.out for r in treqs], tsess, treqs


@pytest.fixture(scope="module")
def served(models):
    return serve(models)


def test_sessions_give_the_same_tokens(served):
    want, got, sess, reqs = served
    assert got == want
    assert all(len(o) == MAX_NEW for o in got) and all(r.done for r in reqs)
    assert not sess.live and not sess.queue


def test_eos_retires_a_request_in_both(models, served):
    eos = served[0][2][1]  # request 2's second token: it retires after two
    want, got, sess, reqs = serve(models, eos_id=eos)
    assert got == want
    assert len(got[2]) == 2 and got[2][-1] == eos
    assert all(r.done for r in reqs) and not sess.live


def test_session_state_matches_reference(models):
    """Positions and the cache layout after serving, against the reference's
    session on the same requests."""
    jmodel, params, tmodel = models
    tsess = ServeSession(tmodel, batch_slots=SLOTS, max_len=MAX_LEN)
    jsess = JSession(jmodel, params, batch_slots=SLOTS, max_len=MAX_LEN)
    for i, p in enumerate(prompts(tmodel.cfg.vocab)[:SLOTS]):
        tsess.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
        jsess.submit(JRequest(rid=i, prompt=p, max_new=MAX_NEW))
    assert tsess.tick() and jsess.tick()
    assert tsess.pos == jsess.pos
    assert sorted(tsess.live) == sorted(jsess.live)
    k = np.asarray(jsess.cache["units"]["b0"]["k"])  # (n_units, B, KH, S, Dh)
    for u in range(k.shape[0]):
        np.testing.assert_allclose(tsess.cache[u]["k"].numpy(), k[u], rtol=1e-4, atol=1e-4)


def test_launcher_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-8b",
         "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "12 tokens" in proc.stdout and "on cpu" in proc.stdout


def test_launcher_int8_raises():
    from repro_torch.launch.serve import main

    with pytest.raises(NotImplementedError, match="8.8"):
        main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--int8"])
