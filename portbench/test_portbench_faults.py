"""``correct`` comes out false when the timed path is broken underneath:
each fault a cell can have is planted in the program (a step that returns
its state unchanged; half of the batch left out, the mean taken over the
rest; the exchange between nodes left out; a token or an answer altered
where it is produced), and a whole run at a small size on the CPU, the
look for a card aside, is judged.  The controls, the reference itself put
in the program's place at TF32 precision, fail too."""

import numpy as np
import pytest
import torch

from pbcore import env

env.prepare()

from pbcore import harness, tiny  # noqa: E402


def _run(cell, seconds=0.3, **extra):
    kw = {k: dict(v) for k, v in tiny.OVERRIDES[cell].items()}
    kw["traffic_overrides"].update(extra)
    return harness.run_cell(cell, 2**31 + 41, seconds, False, device="cpu",
                            **kw)


# --- the logistic-regression grid -----------------------------------------

def _logreg_unchanged(mp):
    from repro_torch.core import algorithm

    def frozen(*a, **k):
        return lambda params, est, batch, phi, alpha, cstate: (params, cstate)

    mp.setattr(algorithm, "build_dpsvrg_inner_step", frozen)
    mp.setattr(algorithm, "build_fused_svrg_inner", frozen)


def _logreg_half_batch(mp):
    from repro_torch.core import algorithm, svrg

    def outer(loss_fn):
        node_grad = algorithm.build_node_grad_fn(loss_fn)

        def traced(state, data):
            half = {k: v[:, :v.shape[1] // 2] for k, v in data.items()}
            return state._replace(
                est=svrg.SvrgState(snapshot=state.anchor,
                                   full_grad=node_grad(state.anchor, half)),
                inner_sum=torch.zeros_like(state.params))
        return traced

    mp.setattr(algorithm, "_svrg_outer_traced", outer)


def _logreg_no_exchange(mp):
    from repro_torch.core import graphs
    mp.setattr(graphs, "b_connected_ring_schedule",
               lambda m, b, seed=0: graphs.static_schedule(np.eye(m)))


def _logreg_answer_altered(mp):
    from repro_torch.core import sweep
    real = sweep.run_sweep

    def altered(*a, **k):
        res = real(*a, **k)
        res.history.objective[-1, 0] *= 1.01
        return res

    mp.setattr(sweep, "run_sweep", altered)


# --- LM training ------------------------------------------------------------

def _train_fault(mp, kind):
    from repro_torch.train import steps
    real = steps.build_train_step

    def build(*a, **k):
        b = real(*a, **k)

        def half(batch):
            return {n: v[:, :v.shape[1] // 2] for n, v in batch.items()}

        def train_step(state, batch, phi, alpha):
            if kind == "half_batch":
                batch = half(batch)
            if kind == "no_exchange":
                phi = torch.eye(phi.shape[-1], dtype=phi.dtype)
            new, metrics = b.train_step(state, batch, phi, alpha)
            if kind == "unchanged":
                return state, metrics
            if kind == "answer_altered":
                metrics = dict(metrics, loss=metrics["loss"] * 1.001)
            return new, metrics

        def snapshot_step(state, big):
            return b.snapshot_step(state, half(big) if kind == "half_batch"
                                   else big)

        return b._replace(train_step=train_step, snapshot_step=snapshot_step)

    mp.setattr(steps, "build_train_step", build)


# --- serving ----------------------------------------------------------------

def _serve_unchanged(mp):
    from repro_torch.models import transformer
    real = transformer.decode_step

    def stuck(cfg, params, cache, token):
        logits, new = real(cfg, params, cache, token)
        return logits, dict(new, pos=cache["pos"])

    mp.setattr(transformer, "decode_step", stuck)


def _serve_half_batch(mp):
    from repro_torch.models import transformer
    real = transformer.prefill

    def half(cfg, params, tokens, *a, **k):
        return real(cfg, params, tokens[:, tokens.shape[1] // 2:], *a, **k)

    mp.setattr(transformer, "prefill", half)


def _serve_token_altered(mp):
    from repro_torch.serve import engine
    calls = []

    def pick(logits):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        calls.append(1)
        if len(calls) == 30:
            tok = (tok + 1) % logits.shape[-1]
        return tok

    mp.setattr(engine, "_greedy", pick)


FAULTS = {
    ("logreg_sweep64", "unchanged"): _logreg_unchanged,
    ("logreg_sweep64", "half_batch"): _logreg_half_batch,
    ("logreg_sweep64", "no_exchange"): _logreg_no_exchange,
    ("logreg_sweep64", "answer_altered"): _logreg_answer_altered,
    ("danube_train_dpsvrg", "unchanged"):
        lambda mp: _train_fault(mp, "unchanged"),
    ("danube_train_dpsvrg", "half_batch"):
        lambda mp: _train_fault(mp, "half_batch"),
    ("danube_train_dpsvrg", "no_exchange"):
        lambda mp: _train_fault(mp, "no_exchange"),
    ("danube_train_dpsvrg", "answer_altered"):
        lambda mp: _train_fault(mp, "answer_altered"),
    ("danube_serve_poisson", "unchanged"): _serve_unchanged,
    ("danube_serve_poisson", "half_batch"): _serve_half_batch,
    ("danube_serve_poisson", "token_altered"): _serve_token_altered,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


CONTROLS = {"logreg_sweep64": ["tf32"], "danube_serve_poisson": ["tf32"],
            "danube_train_dpsvrg": ["tf32", "half_batch", "no_mix"]}
# a served model's control reads the lower precision's first token at the
# served positions: at this size, flips between near-tied logits need a
# few hundred of them
MORE = {"danube_serve_poisson": {"seconds": 1.0, "rate": 60.0}}


@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_the_controls_are_not_correct(cell):
    res = _run(cell, controls=CONTROLS[cell], **MORE.get(cell, {}))
    assert res["correct"], res["checks"]
    for name, numbers in res["controls"].items():
        limits = res["checks"]
        over = [k for k, v in numbers.items()
                if not v["value"] <= limits[k]["limit"]]
        assert over, (name, numbers)
