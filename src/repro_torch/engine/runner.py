"""Model steps for the inference engine.

One ``ModelRunner`` owns the params and a KV cache of ``max_slots`` slots.
Prefill is bucketed by prompt length (power-of-two padding), as the
reference's, whose buckets bound its compilations; decode is one step
over the whole slot batch with per-slot cache lengths.  PyTorch runs
eagerly, so there is nothing to compile, and the cache is written in
place: a prefill writes its slot, a decode step one position per slot.

The recurrent families (``registry.RECURRENT``: ``ssm``, ``hybrid``) are
prefilled at the prompt's true length, a departure from the reference
(ROADMAP §3): their cache is the state after the prefill's last token, so
the reference's pad tokens enter the state that decode continues from.
Eager torch has no compilation for a bucket to bound.

Under a tracer (``obs.trace``) each slot step is a span,
``runner/prefill`` (``tokens``, ``bucket``) or ``runner/decode``, tiled by
two children: ``runner/enqueue``, from entry until the step's last device
work is queued, and ``runner/to_host``, the copy of the logits that waits
for the device.  The spans add no synchronisation; untraced, no span is
made.

A fault of the device inside a step (an illegal address in a kernel, a
failed launch inside torch) surfaces as a torch ``RuntimeError`` at the
step's copy to the host, and leaves the CUDA context unusable, so a retry
cannot succeed.  The steps re-raise it as ``KernelError``, which the
scheduler's fault path does not catch.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._build import KernelError
from repro_torch.models import registry
from repro_torch.obs import trace as _trace

_DEVICE_FAULT_PREFIXES = ("CUDA error", "CUDA driver error")


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _is_device_fault(err: RuntimeError) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(err, accel)) or \
        str(err).startswith(_DEVICE_FAULT_PREFIXES)


@contextlib.contextmanager
def _device_faults():
    """Re-raise a device fault as ``KernelError``; other errors pass as they are."""
    try:
        yield
    except RuntimeError as err:
        if _is_device_fault(err):
            raise KernelError(f"device fault in a model step: {err}") from err
        raise


class ModelRunner:
    """Owns the params and the slot cache of one model."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8, max_seq: int):
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.device = params["embed"]["embedding"].device
        self.cache = registry.init_cache(cfg, max_slots, max_seq, device=self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _extra(self, extra: dict | None) -> dict | None:
        """A request's ``extra`` inputs as tensors on the runner's device
        (``None`` for none, as the reference's ``extra or None``)."""
        if not extra:
            return None
        return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))
                .to(self.device) for k, v in extra.items()}

    # -- prefill one request into a slot --------------------------------
    @torch.inference_mode()
    def prefill_into_slot(self, tokens: np.ndarray, slot: int,
                          extra: dict | None = None) -> np.ndarray:
        """tokens: [T] int32; ``extra``: the request's other inputs (the
        VLM's ``image_embeds`` [1, N, d], whisper's ``audio_frames``
        [1, T_frames, d]). Returns last-token logits [V] (f32).

        The slot's rows of every cache entry are zeroed and written by the
        prefill in place: its first ``bucket`` positions (the cross K/V
        whole), as the reference writes a fresh one-row cache over them;
        a recurrent family's states after token ``T - 1``."""
        t = int(tokens.shape[0])
        assert t <= self.max_seq, f"prompt {t} > max_seq {self.max_seq}"
        bucket = t if self.cfg.family in registry.RECURRENT else min(_bucket(t), self.max_seq)
        tr = _trace.current_tracer()
        with _trace.span_in(tr, "runner/prefill") as sp, _device_faults():
            if tr is not None:
                sp.set(tokens=t, bucket=bucket)
            with _trace.span_in(tr, "runner/enqueue"):
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :t] = tokens
                row = {entry: {name: c[:, slot:slot + 1] for name, c in kv.items()}
                       for entry, kv in self.cache.items()}
                for kv in row.values():
                    for c in kv.values():
                        c.zero_()
                logits, _ = registry.prefill(self.cfg, self.params, self._tensor(padded), row,
                                             extra=self._extra(extra))
                last = logits[0, t - 1].float()
            with _trace.span_in(tr, "runner/to_host"):
                return last.cpu().numpy()

    # -- one decode step over all slots ----------------------------------
    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """tokens: [slots] int32 (next input per slot); lens: [slots] int32.
        Returns logits [slots, V] (f32)."""
        tr = _trace.current_tracer()
        with _trace.span_in(tr, "runner/decode"), _device_faults():
            with _trace.span_in(tr, "runner/enqueue"):
                lens_t = torch.from_numpy(np.asarray(lens, np.int32)).to(self.device)
                logits, _ = registry.decode_step(self.cfg, self.params,
                                                 self._tensor(tokens[:, None]), self.cache,
                                                 lens_t)
                last = logits[:, 0].float()
            with _trace.span_in(tr, "runner/to_host"):
                return last.cpu().numpy()

    # -- whole-sequence scoring (no cache) -------------------------------
    @torch.inference_mode()
    def logprobs(self, tokens: np.ndarray, extra: dict | None = None) -> np.ndarray:
        """tokens: [B,T] -> log-probs [B,T,V] (teacher-forced), f32."""
        logits, _ = registry.forward(self.cfg, self.params, self._tensor(tokens),
                                     extra=self._extra(extra))
        return torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
