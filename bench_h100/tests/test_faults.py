"""The comparison that decides ``correct`` fails a broken run. Each test
skips run.py's look for a card (the CPU rehearsal), breaks the timed path
underneath, drives the rest of the run and reads the line: a sound run
comes out correct under the cell's limits (the train tests: limits of
their own at their size, ``TRAIN_LIMITS``), and each fault the cell can
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
# noise over too few pixels, which B = 16 narrows
TRAIN_MIX = {**TEST_MIX, "batch": 16, "reference_block": 16}
# the train tests' limits at their own size (252², B = 16, the plain
# versions on the CPU), set by PERF.md §2's rule from the readings of seeds
# SEED + 7919 n, n = 0 … 11 (sound runs; the fp8 control, the reference
# with fp8 e4m3 convs and e5m2 output gradients; the half batch):
#   grad1_mid: sound 0.0007–0.0025 (lower 0.00252), fp8 0.0086–0.051
#     (upper 0.00856, 3.4x), half batch 0.0138–1.33, unchanged ~1: 0.005;
#   delta_gap: sound 0.0067–0.0512 (lower), fp8 0.036–0.124 and the half
#     batch 0.070–0.76 under 3x and 10x the lower, so the upper is the
#     unchanged state's 1: 0.25.
# grad1_gap reads sound 0.0051–0.0178 against fp8 0.052–0.91 (2.9x, under
# the 3x an upper needs; the worst leaf a different conv's weight or bias
# on each seed), and not better at B = 32 (sound up to 0.0577) or on a
# 316² tile (fp8 from 0.042, 2.4x): it is read, not compared, here. The
# cells' own limits (limits/*.json) hold at their size on the card.
TRAIN_LIMITS = {"grad1_mid": 0.005, "delta_gap": 0.25}


@pytest.fixture(autouse=True)
def _test_size(monkeypatch):
    monkeypatch.setattr(run, "REHEARSAL", TEST_MODEL)
    monkeypatch.setattr(run, "REHEARSAL_MIX", TEST_MIX)


@pytest.fixture
def _train_size(monkeypatch):
    monkeypatch.setattr(run, "REHEARSAL_MIX", TRAIN_MIX)

    class Cell(registry.Cell):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.limits = dict(TRAIN_LIMITS)

    monkeypatch.setattr(registry, "Cell", Cell)


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
    cell, device = _cell(workload), torch.device("cpu")
    serve = registry.mode("serve")
    rec, values = serve.run(cell, SEED, 0.1, 0, device, True)
    ok, _ = check.verdict(values, cell.limits)
    assert ok
    got = serve.serve_control(cell, SEED, rec["window"]["sample"], device)
    ok, _ = check.verdict(got, cell.limits)
    assert not ok


def test_train_control_is_not_correct():
    """The reference with fp8 convs and fp8 output gradients."""
    cell = _cell("unet512_bf16.train_b128", TRAIN_MIX)
    device = torch.device("cpu")
    train = registry.mode("train")
    rec, values = train.run(cell, SEED, 0.1, 0, device, True)
    assert check.verdict(values, TRAIN_LIMITS)[0]
    got = train.train_faults(cell, SEED, rec["reference"], device)
    assert not check.verdict(got["control"], TRAIN_LIMITS)[0]
