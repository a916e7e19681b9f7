"""``correct`` on the toy fixture: sound runs pass, and a run whose timed path
is broken underneath fails, once for each fault a cell can have (a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; an answer altered where it is produced).  One card
has no exchange between chips to leave out.  The fixture's limits are its
own: at these toy sizes float32 parts from float64 by up to ~1e-2 (small
amplitudes).  The control (TF32 in the place of float32) runs the real
cells and needs a card: it skips here."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import spec
from port_bench.tests.conftest import BORN, BRICK, toy_run

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [BRICK, BORN])
def test_sound_runs_are_correct(workload):
    assert toy_run(workload)["correct"]


def test_fit_step_returning_its_state_unchanged(monkeypatch):
    from tneq_tpu_torch.train import _fit_driver

    real = _fit_driver.FitDrivers.batched

    def unchanged(self, params, masks, *shared, chunk_steps=0):
        p, o, steps, metric = real(self, params, masks, *shared, chunk_steps=chunk_steps)
        b = masks.shape[0]
        return {n: v.expand((b,) + tuple(v.shape)).clone() for n, v in params.items()}, o, steps, metric

    monkeypatch.setattr(_fit_driver.FitDrivers, "batched", unchanged)
    assert not toy_run(BRICK)["correct"]


def test_fit_answer_altered(monkeypatch):
    from tneq_tpu_torch.train import _fit_driver

    real = _fit_driver.FitDrivers.batched

    def altered(self, *args, **kw):
        p, o, steps, metric = real(self, *args, **kw)
        return p, o, steps, metric + torch.where(torch.arange(len(metric)) == 1, 1e-3, 0.0)

    monkeypatch.setattr(_fit_driver.FitDrivers, "batched", altered)
    assert not toy_run(BRICK)["correct"]


def test_train_step_returning_its_state_unchanged(monkeypatch):
    from tneq_tpu_torch.train.trainer import Trainer

    real = Trainer._step

    def unchanged(self, params, opt_state, states, x, reduce=None):
        _, opt_state, loss = real(self, params, opt_state, states, x, reduce)
        return params, opt_state, loss

    monkeypatch.setattr(Trainer, "_step", unchanged)
    assert not toy_run(BORN)["correct"]


def test_train_loss_over_half_the_batch(monkeypatch):
    from tneq_tpu_torch.train.trainer import Trainer

    real = Trainer.loss

    def half(self, params, states, x):
        return real(self, params, states, x[: len(x) // 2])

    monkeypatch.setattr(Trainer, "loss", half)
    assert not toy_run(BORN)["correct"]


def test_train_answer_altered(monkeypatch):
    from tneq_tpu_torch.train.trainer import Trainer

    real = Trainer._step

    def altered(self, *args, **kw):
        params, opt_state, loss = real(self, *args, **kw)
        return params, opt_state, loss * 1.05

    monkeypatch.setattr(Trainer, "_step", altered)
    assert not toy_run(BORN)["correct"]


def test_train_retraction_without_its_sign_fix(monkeypatch):
    from tneq_tpu_torch.optim import stiefel

    def unsigned(x):
        q, _ = torch.linalg.qr(x.mT)
        return q.mT

    monkeypatch.setattr(stiefel, "qr_retraction", unsigned)
    assert not toy_run(BORN)["correct"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(workload):
    """The nearest precision below the configuration's fails, at the cell's
    own size: the fit with its own TF32 path on (matmul precision 'high');
    the trainer's reference put in its place in float32 with its products'
    operands rounded to TF32.
    TF32 exists only on the card: this skips on the host."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    from port_bench import calibrate
    from port_bench.compare import verdict

    checks = calibrate.readings(spec.load_cell(workload), 11, "control", torch.device("cuda", 0))
    assert not verdict(checks)


def test_tf32_rounding_of_the_born_control():
    """The Born-rule control rounds each operand to TF32's 10-bit mantissa,
    to nearest, and passes the gradient through."""
    from port_bench.reference.born import to_tf32

    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 4, 1 + 3 * ulp / 4, -3.0 - ulp / 8], requires_grad=True)
    y = to_tf32(x)
    assert y.tolist() == [1.0, 1.0, 1 + ulp, -3.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0] * 4
    z = to_tf32(torch.complex(torch.tensor([1 + ulp / 4]), torch.tensor([1 + 3 * ulp / 4])))
    assert z.real.item() == 1.0 and z.imag.item() == 1 + ulp
