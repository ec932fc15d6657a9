"""A run with the timed path broken underneath comes out not correct: once
for each fault a served cell can have (a one-card cell has no exchange
between cards to leave out)."""
import pytest
import torch

from bench.testing import run_tiny


def token_altered(eng):
    """Every sampled token off by one, where it is produced."""
    sample = eng._sample
    vocab = eng.cfg.vocab_size
    eng._sample = lambda logits, gen: (sample(logits, gen) + 1) % vocab


def state_unchanged(eng):
    """A decode step that hands back its state as it found it: the carried
    token and the position do not advance."""
    step = eng._slot_step

    def held(st, *args):
        tok, pos = st.tok.clone(), st.pos.clone()
        out = step(st, *args)
        st.tok.copy_(tok)
        st.pos.copy_(pos)
        return out
    eng._slot_step = held


def half_batch(eng):
    """Half of the decode batch left out (the first half of the slots, the
    ones a light load fills): its rows' logits replaced by the mean of the
    rest's."""
    logits = eng._logits

    def half(*args, **kw):
        out = logits(*args, **kw)
        b = out.shape[0]
        if out.shape[1] == 1 and b > 1:
            out = out.clone()
            out[:b // 2] = out[b // 2:].mean(dim=0, keepdim=True)
        return out
    eng._logits = half


@pytest.mark.parametrize("fault", [token_altered, state_unchanged, half_batch],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    with torch.inference_mode():
        res = run_tiny(hook=fault)["result"]
    assert not res["correct"], res["checks"]
