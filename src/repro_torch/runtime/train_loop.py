"""Training loop: the train step, checkpoint/restart, a per-step hook.

Port of ``repro/runtime/train_loop.py``:

  * checkpoint every ``ckpt_every`` steps and at the end (atomic, pruned,
    zstd; ``runtime/checkpoint.py``, the reference's layout and key
    names, so a train checkpoint of either package resumes in the other);
  * on startup, resume from the latest complete checkpoint;
  * the data stream is seeded per (shard, step), so a resumed run takes
    exactly the batches the uninterrupted one would have;
  * ``on_step`` sees each step's loss and wall time (straggler detection,
    ``runtime/straggler.py``).

On the CPU a resumed run is bit-identical to the uninterrupted one.  On
CUDA a backward that adds with atomics (the MoE scatter-add) may round
two runs apart in the last bits.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..data.synthetic import LMStreamConfig, SyntheticLMStream
from . import checkpoint as ckpt
from .steps import build_train_step, init_train_state


@dataclass
class TrainResult:
    losses: List[float] = field(default_factory=list)
    steps: int = 0
    resumed_from: Optional[int] = None
    step_times: List[float] = field(default_factory=list)


def _load_into(state, restored) -> None:
    """Copy a restored tree of host arrays into ``state``'s tensors (bf16
    leaves come back as their ``uint16`` view)."""
    if isinstance(state, dict):
        for k in state:
            _load_into(state[k], restored[k])
        return
    if isinstance(state, tuple):
        for a, b in zip(state, restored):
            _load_into(a, b)
        return
    arr = np.asarray(restored)
    if state.dtype == torch.bfloat16:
        src = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        src = torch.from_numpy(np.ascontiguousarray(arr))
    state.copy_(src.reshape(state.shape))


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(cfg: ArchConfig, *, n_steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          seed: int = 0, log_every: int = 10,
          on_step: Optional[Callable[[int, Dict], None]] = None,
          device: DeviceLike = None) -> TrainResult:
    """Train ``cfg`` on the synthetic k-gram stream on ``device`` (default
    ``cuda:0``) for steps ``[start, n_steps)``, ``start`` being the step of
    the latest checkpoint in ``ckpt_dir`` (0 without one)."""
    dev = resolve_device(device)
    state = init_train_state(cfg, seed=seed, device=dev)
    step_fn = build_train_step(cfg)
    stream = SyntheticLMStream(LMStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed))

    result = TrainResult()
    start = 0
    if ckpt_dir:
        got = ckpt.restore_latest(ckpt_dir, state)
        if got is not None:
            start, restored = got
            _load_into(state, restored)
            result.resumed_from = start

    for step in range(start, n_steps):
        batch = batch_to(stream.batch(step), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        result.losses.append(loss)
        result.step_times.append(dt)
        result.steps = step + 1
        if on_step is not None:
            on_step(step, {"loss": loss, "time": dt})
        if log_every and step % log_every == 0:
            print(f"step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state)
    if ckpt_dir and result.steps > start:
        ckpt.save(ckpt_dir, result.steps, state)
    return result
