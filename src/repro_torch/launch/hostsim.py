"""Simulated topology: a ``fake`` process group of N ranks in one process.

The port of ``repro/launch/hostsim.py``.  The reference forces N host
devices through ``XLA_FLAGS`` before jax starts; the port starts PyTorch's
``fake`` process-group backend, in which one process is rank 0 of a world
of N and every collective returns at once without moving data.  DTensors on
a mesh of that world run each op on rank 0's blocks and issue the
collectives a real world would, which is what the dry run costs.

The backend lives in a private module
(``torch.testing._internal.distributed.fake_pg``); where it is missing,
``ensure_fake_world`` raises and says so.

  * ``ensure_fake_world(n)`` starts the fake world of ``n`` ranks once (a
    fake world of another size is replaced), and refuses to replace a
    process group that is not fake;
  * ``fake_world_plan(n)`` is the pure variant: what ``ensure_fake_world``
    would do, touching nothing;
  * ``close_fake_world()`` ends a fake world (tests end theirs: the world
    is process-global).
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["FAKE_BACKEND", "fake_world_plan", "ensure_fake_world",
           "close_fake_world"]

FAKE_BACKEND = "fake"


def _current() -> Optional[Dict[str, object]]:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return None
    return {"backend": str(dist.get_backend()),
            "world_size": dist.get_world_size()}


def fake_world_plan(n: int, current: Optional[Dict[str, object]] = None
                    ) -> Dict[str, object]:
    """What ``ensure_fake_world(n)`` would do with ``current`` (the running
    group's ``{"backend", "world_size"}``, None for none): ``{"action":
    "start" | "keep" | "replace" | "refuse", "world_size": n, "reason"}``."""
    if n < 1:
        raise ValueError(f"a world has at least one rank, not {n}")
    if current is None:
        return {"action": "start", "world_size": n, "reason": ""}
    if current["backend"] != FAKE_BACKEND:
        return {"action": "refuse", "world_size": n,
                "reason": f"a real {current['backend']!r} process group of "
                          f"{current['world_size']} ranks is running"}
    if current["world_size"] == n:
        return {"action": "keep", "world_size": n, "reason": ""}
    return {"action": "replace", "world_size": n,
            "reason": f"the fake world has {current['world_size']} ranks"}


def ensure_fake_world(n: int) -> int:
    """Make this process rank 0 of a fake world of ``n`` ranks; returns
    ``n``.  Raises ``RuntimeError`` instead of replacing a real group, and
    where the fake backend is missing."""
    import torch.distributed as dist
    plan = fake_world_plan(n, _current())
    if plan["action"] == "refuse":
        raise RuntimeError(f"will not start a fake world of {n} ranks: "
                           f"{plan['reason']}")
    if plan["action"] == "keep":
        return n
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the 'fake' process-group backend is missing: it lives in the "
            f"private module torch.testing._internal.distributed.fake_pg, "
            f"which this PyTorch ({e}) does not have") from e
    if plan["action"] == "replace":
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, rank=0, world_size=n,
                            store=FakeStore())
    return n


def close_fake_world() -> None:
    """End the fake world, if one is running (never a real group)."""
    import torch.distributed as dist
    cur = _current()
    if cur is not None and cur["backend"] == FAKE_BACKEND:
        dist.destroy_process_group()
