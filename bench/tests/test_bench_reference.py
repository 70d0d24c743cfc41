"""The plain reference against repro_torch at smoke size on the CPU, on
the benchmark's own weights: dense and expert layers (the mixtral
configuration waits for a cell: PERF.md), the logits at every position;
the float8 control lands far from both."""
import dataclasses

import pytest
import torch

import repro_torch
from bench.reference.transformer import Reference, capacity
from bench.tests import smoke

CONFIGS = ["deepseek-7b", "mixtral-8x22b"]


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _program_logits(fam, w, tokens):
    from repro_torch.models import registry
    logits, _ = registry.forward(fam.program.config(fam.arch), fam.program.params(w, fam.arch),
                                 tokens[None])
    return logits[0].float()


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_matches_program(config):
    fam = smoke.family_of(config)
    a = fam.arch
    w = fam.weights(2**31 + 3, torch.device("cpu"))
    tokens = torch.randint(0, a.vocab, (37,), generator=torch.Generator().manual_seed(0))
    prog = _program_logits(fam, w, tokens)
    caps = [37] if a.is_moe else None
    ref = Reference(w, a).logits([tokens], [torch.arange(37)], cap_lens=caps)[0]
    assert (prog - ref).abs().max().item() < 1e-4
    lowp = Reference(w, a, precision="fp8").logits([tokens], [torch.arange(37)], cap_lens=caps)[0]
    assert (lowp - ref).abs().max().item() > 100 * (prog - ref).abs().max().item()


def test_capacity_drops_in_token_order():
    """A router that sends every token to experts 0 and 1 fills them:
    the choices past capacity are dropped, as the program drops them."""
    fam = smoke.family_of("mixtral-8x22b")
    fam = dataclasses.replace(fam, arch=dataclasses.replace(fam.arch, layers=1))
    a = fam.arch
    w = fam.weights(7, torch.device("cpu"))
    w["router"].zero_()
    w["router"][:, :, 0] = 0.0
    w["router"][:, :, 1] = 0.0
    w["router"][:, :, 2:] = -1e4 / a.d                  # experts 2.. never chosen
    tokens = torch.arange(1, 40)
    cap = capacity(a, 39)
    assert cap < 39                                     # experts 0 and 1 overflow
    prog = _program_logits(fam, w, tokens)
    ref = Reference(w, a).logits([tokens], [torch.arange(39)], cap_lens=[39])[0]
    assert (prog - ref).abs().max().item() < 1e-4
    dropless = Reference(w, a).logits([tokens], [torch.arange(39)])[0]
    assert (dropless - ref)[cap:].abs().max().item() > 1e-2   # the drops matter
