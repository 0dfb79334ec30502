"""The host-side rules of ``chip_smoke.py``'s first-token gate (phase 5),
which run on the CPU: ``_bf16_step``, the spacing of bf16 values at a
magnitude, and ``_logits_agree``, which holds two engines' first tokens to
the same top-1 and lets two differing tokens pass only where the fp32
witness puts their logits at most ``TIE_STEPS`` bf16 steps apart."""

import math

import pytest
import torch

import chip_smoke as cs


@pytest.mark.parametrize("x", [0.37, 1.0, 1.5, 2.0, 3.99, 7.0, 12.5, 100.0,
                               1000.0, -3.0, 2.0**-7, 65504.0])
def test_bf16_step_is_the_spacing_of_bf16_values(x):
    xb = torch.tensor(x).bfloat16().float()
    step = cs._bf16_step(xb)
    assert step.item() == 2.0**(math.floor(math.log2(abs(xb.item()))) - 7)
    # the next bf16 value up is one step away, and less than half a step
    # rounds back
    up = xb + step
    assert up.bfloat16().float().item() == up.item()
    assert (xb + 0.49 * step).bfloat16().float().item() == xb.item()


def _pair(gap_steps, vocab=64, top=10.0):
    """Reference logits ``want`` whose best token is b, logits ``got`` a hair
    apart whose best token is a, and an fp32 witness that puts a at ``top``
    and b ``gap_steps`` bf16 steps below it."""
    gen = torch.Generator().manual_seed(0)
    want = torch.randn(vocab, generator=gen)
    a, b = 3, 7
    want[b], want[a] = top, top - 0.01
    got = want.clone()
    got[a] = top + 0.01
    witness = want.clone()
    witness[a] = top
    witness[b] = top - gap_steps * cs._bf16_step(torch.tensor(top)).item()
    return got, want, witness


@pytest.mark.parametrize("gap_steps, tie", [(0.0, True), (0.5, True),
                                            (1.0, True), (1.25, False),
                                            (3.0, False)])
def test_differing_first_tokens_pass_only_within_a_bf16_step(gap_steps, tie):
    got, want, witness = _pair(gap_steps)
    assert cs._logits_agree("pair", [got], [want], ties=[witness]) is tie


def test_the_same_first_token_needs_no_witness():
    got, want, _ = _pair(0.0)
    got[3] = want[3]
    assert cs._logits_agree("same", [got], [want])
    assert cs._logits_agree("same", [got], [want], ties=[want])


def test_differing_first_tokens_without_a_witness_fail():
    got, want, _ = _pair(0.0)
    assert not cs._logits_agree("no witness", [got], [want])


def test_a_tie_does_not_excuse_the_relative_l2_gate():
    got, want, witness = _pair(0.0)
    got = got + 0.5 * want.norm() / math.sqrt(want.numel())
    assert not cs._logits_agree("far", [got], [want], ties=[witness])
