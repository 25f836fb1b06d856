"""Whole runs on the CPU at a small size, the look for a card skipped:
a sound run comes out ``correct``, and each fault the cell can have,
planted in the program under the timed path, makes ``correct`` false."""
import json

import numpy as np
import pytest
import torch

import harness
import tiny

CELLS = [w["name"] for w in json.loads(
    (tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]
    + tiny.LATER["workloads"]]


def answer_altered(monkeypatch):
    """One prediction of each batch turned over where the forward
    produces it (p -> 1 - p), before it is blended."""
    from chunkflow_tpu_torch.ops import accumulate

    real = accumulate.fused_accumulate_patches

    def altered(out, weight, preds, valid, bump, starts, **kw):
        preds = preds.clone()
        preds[0] = 1.0 - preds[0]
        return real(out, weight, preds, valid, bump, starts, **kw)

    monkeypatch.setattr(accumulate, "fused_accumulate_patches", altered)


def half_batch_left_out(monkeypatch):
    """The second half of each batch left out of the blend: its weight is
    0, so each voxel is the weighted mean over the rest."""
    from chunkflow_tpu_torch.ops import accumulate

    real = accumulate.fused_accumulate_patches

    def halved(out, weight, preds, valid, bump, starts, **kw):
        valid = valid.clone()
        valid[len(valid) // 2:] = 0.0
        return real(out, weight, preds, valid, bump, starts, **kw)

    monkeypatch.setattr(accumulate, "fused_accumulate_patches", halved)


def output_lost_on_save(monkeypatch):
    """The worker's saves write zeros in place of the task's output."""
    from chunkflow_tpu_torch.volume.storage import PrecomputedBackend

    real = PrecomputedBackend.write_async

    def zeros(self, lo, hi, arr):
        return real(self, lo, hi, np.zeros_like(arr))

    monkeypatch.setattr(PrecomputedBackend, "write_async", zeros)


FAULTS = {"answer_altered": answer_altered,
          "half_batch_left_out": half_batch_left_out,
          "output_lost_on_save": output_lost_on_save}


def run(tmp_path, name):
    torch.manual_seed(0)
    root = tiny.make(tmp_path)
    cell = harness.Cell(name, root, root / "portbench")
    return cell, harness.execute(cell, 2**31 + 101, 3.0, False,
                                 device="cpu", tmp_root=str(tmp_path))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tmp_path, name):
    cell, result = run(tmp_path, name)
    assert result["correct"], result["checked"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


# only the worker saves its output
CASES = [(name, fault) for name in CELLS for fault in sorted(FAULTS)
         if fault != "output_lost_on_save" or name.endswith(".worker")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_makes_the_run_incorrect(tmp_path, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    _, result = run(tmp_path, name)
    assert result["correct"] is False, result["checked"]
