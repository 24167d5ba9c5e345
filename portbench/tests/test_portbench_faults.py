"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, through the rest of
a run (the look for a card skipped, the tiny cells on the CPU).  The
exchange between cards has no cell to break: every cell takes one."""

import pytest

from portbench.tests.tiny import make_bench, run_cell


@pytest.fixture
def bench(tmp_path):
    return make_bench(tmp_path)


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.batch"])
def test_sound_serving_runs_are_correct(bench, cell):
    assert run_cell(bench, cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.batch"])
def test_a_decode_step_that_leaves_its_cache_unchanged(bench, cell,
                                                       monkeypatch):
    from repro_torch.serving import ServingEngine

    real = ServingEngine._run_decode

    def unchanged(self):
        saved = {n: t.clone() for n, t in self.kv_pool.items()}
        out = real(self)
        for n, t in self.kv_pool.items():
            t.copy_(saved[n])
        return out

    monkeypatch.setattr(ServingEngine, "_run_decode", unchanged)
    assert not run_cell(bench, cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.batch"])
def test_a_token_altered_where_it_is_produced(bench, cell, monkeypatch):
    from repro_torch.serving import ServingEngine

    real = ServingEngine._emit

    def altered(self, res, tok, final):
        if len(res.output) == 2:
            tok = (tok + 1) % (self.cfg.vocab - 1)
        return real(self, res, tok, final)

    monkeypatch.setattr(ServingEngine, "_emit", altered)
    assert not run_cell(bench, cell)["correct"]


def test_a_sound_training_run_is_correct(bench):
    assert run_cell(bench, "tiny.train")["correct"]


def test_a_train_step_that_leaves_its_state_unchanged(bench, monkeypatch):
    from repro_torch.training import trainer

    monkeypatch.setattr(trainer, "adamw_update",
                        lambda grads, state, params, **kw: state)
    assert not run_cell(bench, "tiny.train")["correct"]


def test_half_the_batch_left_out(bench, monkeypatch):
    from repro_torch.training import trainer

    real = trainer.loss_and_grads

    def half(loss_fn, model, batch, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return real(loss_fn, model, {k: v[:rows] for k, v in batch.items()},
                    **kw)

    monkeypatch.setattr(trainer, "loss_and_grads", half)
    out = run_cell(bench, "tiny.train")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > \
        out["checks"]["loss_gap"]["limit"]
