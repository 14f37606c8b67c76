"""What decides ``correct`` fails where it must: the program's
lower-precision control (``march_bf16``) and, with the timed path broken
underneath, each fault a cell can have. The harness's look for a card is
skipped; the cells run at toy size on the CPU (the port's plain versions),
and the control again at the cells' own sizes on the card."""

from __future__ import annotations

import json

import pytest
import torch

from raybench import core
from raybench.tests.conftest import TOY, correct, run_json, toy_run

ONE_CHIP = ["fit512", "fly1080"]
FAULTS = {"fit512": ["unchanged", "half_batch"], "fly1080": ["altered"]}


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_sound_run_is_correct(cell):
    assert correct(toy_run(cell))


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_is_not_correct(cell):
    part = toy_run(cell, control=True)
    assert not correct(part), {c.name: c.value for c in part["checks"]}


@pytest.mark.parametrize("cell, fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_fault_is_not_correct(cell, fault):
    part = toy_run(cell, fault=fault)
    assert not correct(part), {c.name: c.value for c in part["checks"]}


def bandfit_run(args: list) -> tuple[int, dict | None, str]:
    over = json.dumps(TOY["fit4k.x4"])
    return run_json(["--workload", "fit4k.x4", "--seed", "5", "--seconds", "0.05",
                     "--device", "cpu", "--world", "2", "--override", over, *args],
                    core.root())


def bandfit(args: list) -> dict:
    rc, out, err = bandfit_run(args)
    assert rc == 0 and out is not None, err[-3000:]
    return out


def test_bandfit_sound_on_two_gloo_ranks_is_correct():
    out = bandfit([])
    assert out["correct"] and out["checks"]["rank_param_diff"]["value"] == 0.0
    assert out["device"]["count"] == 2


@pytest.mark.parametrize("args", [["--control"], ["--fault", "unchanged"],
                                  ["--fault", "half_batch"], ["--fault", "no_exchange"]])
def test_bandfit_control_and_faults_are_not_correct(args):
    assert not bandfit(args)["correct"]


def test_a_rank_that_holds_jax_refuses_the_run():
    rc, out, err = bandfit_run(["--fault", "held_on_rank1"])
    assert rc != 0 and out is None
    assert "['jax']" in err, err[-3000:]


@pytest.mark.cuda
def test_a_fault_in_the_replay_alone_is_not_correct_on_the_card(cuda_card):
    """The compared steps are the graph's replay: a capture without the
    optimizer's step fails, though the eager warm-up keeps it."""
    c = core.load_cell("fit512")
    for seed in (2147483921, 2147483922, 2147483923):
        ctx = core.Context(c, seed, 0.5, False, cuda_card)
        assert correct(core.run_rank(ctx, 0.0, log=lambda m: None))
        ctx = core.Context(c, seed, 0.5, False, cuda_card, fault="replay_no_update")
        part = core.run_rank(ctx, 0.0, log=lambda m: None)
        assert not correct(part), {x.name: x.value for x in part["checks"]}
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_fails_at_the_cells_size_on_the_card(cuda_card, cell):
    c = core.load_cell(cell)
    for seed in (2147483911, 2147483912, 2147483913):
        ctx = core.Context(c, seed, 0.5, False, cuda_card, control=True)
        part = core.run_rank(ctx, 0.0, log=lambda m: None)
        assert not correct(part), {x.name: x.value for x in part["checks"]}
        torch.cuda.empty_cache()
