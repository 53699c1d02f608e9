"""Device resolution shared by every entry point of the port.

The JAX package sniffs its backend (``repro.kernels.runtime.
resolve_interpret``: compiled on a TPU, interpreted elsewhere).  The port
runs on the card unless the caller asks for the CPU: ``device=None`` means
CUDA and raises when no card is visible.  There is no silent CPU
fallback; the CPU (where each kernel wrapper takes its plain PyTorch
version) has to be asked for by name, as the tests do.

It also holds the census hooks of ``repro_torch.analysis.ir``: every
kernel entry brackets its launch (or its plain version) in
:func:`census_launch`, and the sweep engine reports each loop
(:func:`census_loop`) and each step (:func:`census_step`).  While no
census records, each hook costs one check of a module global.
"""
from __future__ import annotations

import contextlib

import torch

#: the census recording this process's dispatches, set only by
#: ``repro_torch.analysis.ir`` while it records; ``None`` otherwise
_census = None
_NO_CENSUS = contextlib.nullcontext()


def census_launch(symbol: str, rows: int, q: int | None):
    """Bracket one kernel launch: ``symbol`` over ``rows`` instances and
    a queue of ``q`` entries (``None``: the dense form).  Ops dispatched
    inside the bracket are the kernel's body, not its caller's."""
    if _census is None:
        return _NO_CENSUS
    return _census.launch(symbol, rows, q)


def census_loop(chunk: int, step_fn, cond_fn, carry, pass_gate: bool):
    """Bracket one engine loop run in chunks of ``chunk`` steps from
    ``carry`` (the loop's arguments, for a census that replays a chunk)."""
    if _census is None:
        return _NO_CENSUS
    return _census.loop(chunk, step_fn, cond_fn, carry, pass_gate)


def census_step() -> None:
    """Mark the start of one engine step."""
    if _census is not None:
        _census.step()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); ``"cpu"`` or a
    ``torch.device`` pass through after checking they are usable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the card by "
                "default — pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def check_operand(name: str, x: torch.Tensor, shape: tuple,
                  device: torch.device) -> None:
    """A kernel operand must be int32, contiguous, of ``shape`` and on
    ``device``; raise on anything else."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, not {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
