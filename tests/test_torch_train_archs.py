"""One train step of every catalog arch's smoke config, the port against
``repro`` on the CPU (the port's mirror of
``test_arch_smoke.py::test_train_step``): the same JAX-drawn weights, batch
and extra inputs through ``make_train_step(microbatches=2)`` of both
packages, then the loss, the global gradient norm and the updated params.

Tolerances: the loss and ``grad_norm`` within ``rtol=1e-4`` (f32 sums in
another order through each family's layers; the MoE layers route
identically, ties to the lowest expert).  The updated params are bf16,
rounded from f32 master weights that the first AdamW step moves by
``lr * g / (|g| + eps)``, about ``lr`` for every weight with a gradient
clear of ``eps``: so 99.5% of each leaf's elements must round to the same
bf16 value or one unit apart, and none may differ by more than ``2 * lr``
(a gradient element within rounding of 0 may take the other sign) plus a
bf16 unit of the weight."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro.train.trainstep import make_train_step as jmake
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.models import registry as treg
from repro_torch.train import optimizer as opt
from repro_torch.train.trainstep import make_train_step

B, S = 4, 16


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _extra(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "audio":
        return {"audio_frames": rng.normal(size=(b, cfg.num_audio_frames, cfg.d_model))
                .astype(np.float32)}
    return {}


def _bf16_key(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns on a monotonic integer scale."""
    b = bits.astype(np.int64)
    return np.where(b >= 0, b, -(b & 0x7FFF))


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_train_step_matches_reference(arch):
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    kw = dict(total_steps=2, warmup_steps=1)
    tocfg, jocfg = opt.OptimizerConfig(**kw), jopt.OptimizerConfig(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    tp = tcommon.params_from_numpy(treg.param_specs(tcfg), flat)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    extra = _extra(tcfg, B, seed=3)

    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    jp2, _, jm = jax.jit(jmake(jcfg, jocfg, microbatches=2))(jp, jopt.init_state(jp, jocfg),
                                                             jbatch)
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
              **{k: torch.from_numpy(v) for k, v in extra.items()}}
    tp2, _, tm = make_train_step(tcfg, tocfg, microbatches=2)(tp, opt.init_state(tp, tocfg),
                                                               tbatch)

    assert np.isfinite(float(tm["loss"])) and np.isfinite(float(tm["grad_norm"]))
    for k in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    lr = float(jm["lr"])
    np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
    got = tcommon.flatten(tp2)
    moved = 0.0
    for p, w in jcommon.flatten(jp2).items():
        g, w = got[p], np.asarray(w)
        assert str(g.dtype).split(".")[-1] == w.dtype.name, p
        if g.dtype == torch.bfloat16:
            gk = _bf16_key(g.view(torch.int16).numpy())
            wk = _bf16_key(w.view(np.int16))
            assert np.mean(np.abs(gk - wk) <= 1) >= 0.995, p
            gf, wf = g.float().numpy(), w.astype(np.float32)
        else:
            gf, wf = g.numpy(), w
        bound = 2 * lr + np.abs(wf) * 2 ** -7 + 1e-12
        assert np.all(np.abs(gf - wf) <= bound), (p, float(np.abs(gf - wf).max()))
        moved = max(moved, float(np.abs(wf - np.asarray(flat[p], np.float32)).max()))
    assert moved > 0    # the step changed the params
