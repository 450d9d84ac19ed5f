"""Byte/op throttle (src/common/Throttle.{h,cc} analog): blocking budget used
by messenger policies and the OSD front door."""

from __future__ import annotations

from ceph_tpu_torch.common import lockdep


class Throttle:
    def __init__(self, name: str, max_amount: int):
        self.name = name
        self._max = max_amount
        self._current = 0
        # waiters hold no other lock (messenger deliver waits before
        # taking any)
        self._cond = lockdep.make_condition(f"Throttle::cond({name})")

    @property
    def max_amount(self) -> int:
        return self._max

    @property
    def current(self) -> int:
        with self._cond:
            return self._current

    def get(self, amount: int, timeout: float | None = None) -> bool:
        """Block until ``amount`` fits in the budget (Throttle::get)."""
        with self._cond:
            if self._max == 0:
                return True
            ok = self._cond.wait_for(
                lambda: self._current + amount <= self._max, timeout)
            if not ok:
                return False
            self._current += amount
            return True

    def get_or_fail(self, amount: int) -> bool:
        with self._cond:
            if self._max and self._current + amount > self._max:
                return False
            self._current += amount
            return True

    def put(self, amount: int) -> None:
        with self._cond:
            self._current = max(0, self._current - amount)
            self._cond.notify_all()
