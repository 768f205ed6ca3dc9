"""The comparison that decides ``correct`` fails a broken run. Each test
skips run.py's look for a card (the CPU rehearsal), breaks the timed path
underneath, drives the rest of the run and reads the line: a sound run
comes out correct under the cell's limits, and each fault the cell can
have comes out not correct. A one-chip cell has no exchange between chips
to leave out.

The control of each cell (the program's int8 route for bf16 serving, the
reference one precision down elsewhere) is held to the same limits in the
``*_control_is_not_correct`` tests: on the chip it is read at the cell's
own size by control.py.
"""

import json

import pytest
import torch

import check
import registry
import run
import systems

SEED = 2**31 + 11
# the test size: the published widths on a 252² tile, four images a batch
# (at the CPU rehearsal's 188² the output is 4 × 4 pixels, and a sound
# train step's gradients are rounding noise)
TEST_MODEL = {"input_dims": [252, 252], "n_kernels": 32}
TEST_MIX = {"batch": 4, "pool": 4, "sample": 2, "reference_block": 4,
            "rate": 20}
# a train step at B = 4 reads its loss within ~3e-4 of f32's: rounding
# noise over too few pixels for the cell's limit, which B = 16 meets
TRAIN_MIX = {**TEST_MIX, "batch": 16, "reference_block": 16}


@pytest.fixture(autouse=True)
def _test_size(monkeypatch):
    monkeypatch.setattr(run, "REHEARSAL", TEST_MODEL)
    monkeypatch.setattr(run, "REHEARSAL_MIX", TEST_MIX)


@pytest.fixture
def _train_size(monkeypatch):
    monkeypatch.setattr(run, "REHEARSAL_MIX", TRAIN_MIX)


def _cell(workload, mix=TEST_MIX):
    cell = registry.Cell(workload)
    cell.cfg.update(TEST_MODEL)
    cell.mix.update({k: v for k, v in mix.items() if k in cell.mix})
    return cell


def _line(workload, capsys, seconds="0.2"):
    rc = run.main(["--workload", workload, "--seed", str(SEED),
                   "--seconds", seconds, "--trace", "0", "--rehearse"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _break_server(monkeypatch, fault):
    real = systems.server

    def broken(*args, **kw):
        srv = real(*args, **kw)
        call = type(srv).__call__

        class Broken(type(srv)):
            def __call__(self, x):
                out = call(self, x).clone()
                if fault == "answer_altered":
                    out[0] = 1 - out[0]
                elif fault == "half_batch":
                    out[out.shape[0] // 2:] = 0
                return out

        return Broken(srv.model, srv.params, srv.prepared)

    monkeypatch.setattr(systems, "server", broken)


SERVE_CELLS = ["unet512_bf16.serve_b8", "unet512_bf16.serve_b64",
               "unet512_int8.serve_b64"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_sound_serving_run_is_correct(workload, capsys):
    assert _line(workload, capsys)["correct"] is True


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serving_fault_is_not_correct(workload, fault, monkeypatch, capsys):
    _break_server(monkeypatch, fault)
    line = _line(workload, capsys)
    assert line["correct"] is False and line["failed"] > 0


def _break_trainer(monkeypatch, fault):
    real = systems.Trainer.__init__

    def init(self, *args, **kw):
        real(self, *args, **kw)
        step = self.trainer.train_step
        if fault == "state_unchanged":
            def broken(batch):
                loss = float(self.trainer.loss_and_grads(batch)[0])
                return {"seg_loss": loss, "seg_xentropy": loss}
        else:  # half of the batch left out, the mean over the rest
            def broken(batch):
                n = batch["image"].shape[0] // 2
                return step({k: v[:n] for k, v in batch.items()})
        self.step = broken

    monkeypatch.setattr(systems.Trainer, "__init__", init)


def test_sound_train_run_is_correct(_train_size, capsys):
    assert _line("unet512_bf16.train_b128", capsys)["correct"] is True


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(fault, _train_size, monkeypatch,
                                    capsys):
    _break_trainer(monkeypatch, fault)
    assert _line("unet512_bf16.train_b128", capsys)["correct"] is False


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serving_control_is_not_correct(workload):
    """The configuration's control on the sound run's sample: the program's
    int8 route (bf16 cells), the reference with int4 layers (int8 cells)."""
    import control

    cell, device = _cell(workload), torch.device("cpu")
    rec, values = run.serve(cell, SEED, 0.1, 0, device, True)
    ok, _ = check.verdict(values, cell.limits)
    assert ok
    got = control.serve_control(cell, SEED, rec["window"]["sample"], device)
    ok, _ = check.verdict(got, cell.limits)
    assert not ok


def test_train_control_is_not_correct():
    """The reference with fp8 convs and fp8 output gradients."""
    import control

    cell = _cell("unet512_bf16.train_b128", TRAIN_MIX)
    device = torch.device("cpu")
    rec, values = run.train(cell, SEED, 0.1, 0, device, True)
    assert check.verdict(values, cell.limits)[0]
    got = control.train_faults(cell, SEED, rec["reference"], device)
    assert not check.verdict(got["control"], cell.limits)[0]
