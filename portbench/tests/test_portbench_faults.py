"""A run with the timed path broken underneath comes out not correct,
with the cells' own limits: an answer altered where it is produced; a
train step that leaves its state unchanged; half of the batch left out,
the mean taken over the rest; the loss doubled where it is produced.
(One card: no exchange between cards to leave out.)"""
import pytest

from helpers import TRAIN, run_cpu, tiny_cell, tiny_mesa_cell


def altered_embed(model, dtype):
    from hotformerloc_torch.evaluation.embed import make_embed_fn
    embed = make_embed_fn(model, dtype)

    def call(points, pmask):
        out = dict(embed(points, pmask))
        g = out["global"].clone()
        g[0, 0] += 0.25
        out["global"] = g
        return out
    return call


def test_serve_altered_answer_is_not_correct():
    out = run_cpu(tiny_cell("oxford-serve-b32", check={"sample": 10 ** 6,
                                                       "chunk": 4}),
                  hooks={"embed": altered_embed})
    assert not out["correct"]
    assert out["checks"]["desc_max_abs"]["value"] > 0.2


def unchanged(step):
    def call(batch, seed):
        keep = {k: v.clone() for k, v in step.model.state_dict().items()}
        stats = step(batch, seed)
        step.model.load_state_dict(keep)
        if step.state.ema_model is not None:
            step.state.ema_model.load_state_dict(keep)
        return stats
    return call


def half_batch(step):
    def call(batch, seed):
        h = batch["points"].shape[0] // 2
        return step({"points": batch["points"][:h],
                     "pmask": batch["pmask"][:h],
                     "positives_mask": batch["positives_mask"][:h, :h],
                     "negatives_mask": batch["negatives_mask"][:h, :h]},
                    seed)
    return call


def altered_loss(loss_fn):
    """The loss doubled where it is produced (two microbatches summed
    where they are averaged): every gradient with it."""
    def call(*args, **kw):
        loss, stats = loss_fn(*args, **kw)
        return 2.0 * loss, stats
    return call


@pytest.mark.parametrize("mesa", [False, True])
@pytest.mark.parametrize("hook,fault", [("train_step", unchanged),
                                        ("train_step", half_batch),
                                        ("loss_fn", altered_loss)])
def test_train_fault_is_not_correct(mesa, hook, fault):
    cell = tiny_mesa_cell() if mesa else tiny_cell(TRAIN)
    out = run_cpu(cell, hooks={hook: fault})
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
