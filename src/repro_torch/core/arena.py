"""Two-stack arena allocator (paper §4.4.1, Figure 3).

The application hands the interpreter ONE contiguous memory arena.  All
allocation happens during initialization; nothing may allocate during
invoke.  Two stacks grow toward each other:

    +------------------------------------------------------------------+
    | head →  (nonpersistent / function-lifetime)     temp     ← tail  |
    |                                               (persistent)       |
    +------------------------------------------------------------------+

* ``head`` grows upward from offset 0: function-lifetime data — the
  memory-planner-compacted activation/scratch section, reusable between
  invocations (and between models under multitenancy, §4.5).
* ``tail`` grows downward from ``size``: interpreter-lifetime data —
  tensor runtime metadata, requant tables, variable tensors, the plan.
* the gap between the stacks doubles as a *temporary* allocation region
  used only while memory planning runs (paper: "we used the space in
  between the two stacks as temporary allocations when a model is in
  memory planning"); it must be reset before invoke.

When the two stack pointers cross we raise — the TFLM application-level
"arena too small" error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

DEFAULT_ALIGN = 16


class ArenaOverflowError(MemoryError):
    """Head and tail stacks crossed: the supplied arena is too small."""


def align_up(n: int, a: int = DEFAULT_ALIGN) -> int:
    return (n + a - 1) & ~(a - 1)


def align_down(n: int, a: int = DEFAULT_ALIGN) -> int:
    return n & ~(a - 1)


@dataclass
class Allocation:
    """One recorded arena allocation: byte offset, size, and the tag
    that names what lives there (for the memory report)."""

    offset: int
    nbytes: int
    tag: str


@dataclass
class ArenaUsage:
    """Snapshot of arena occupancy: persistent (tail) and nonpersistent
    (head) bytes, planning-time temp high water, and capacity — the
    numbers behind the Table-2 memory split."""

    persistent: int
    nonpersistent: int
    temp_high_water: int
    total: int
    capacity: int


class TwoStackArena:
    """Byte-exact two-stack allocator over a fixed-size arena."""

    def __init__(self, size_bytes: int, alignment: int = DEFAULT_ALIGN):
        if size_bytes <= 0:
            raise ValueError("arena size must be positive")
        self.size = int(size_bytes)
        self.alignment = alignment
        self._head = 0                  # first free byte of the head stack
        self._tail = self.size          # one past last used byte of tail
        self._temp = 0                  # bytes currently allocated in temp
        self._temp_high_water = 0
        self._frozen = False
        self.head_allocs: List[Allocation] = []
        self.tail_allocs: List[Allocation] = []

    # ------------------------------------------------------------------
    def _check_cross(self, head: int, tail: int) -> None:
        if head + self._temp > tail:
            raise ArenaOverflowError(
                f"arena exhausted: head={head} + temp={self._temp} "
                f"crosses tail={tail} (capacity {self.size})")

    def allocate_persistent(self, nbytes: int, tag: str = "") -> int:
        """Tail stack: interpreter-lifetime. Returns the offset."""
        self._assert_not_frozen()
        nbytes = int(nbytes)
        new_tail = align_down(self._tail - nbytes, self.alignment)
        self._check_cross(self._head, new_tail)
        self._tail = new_tail
        self.tail_allocs.append(Allocation(new_tail, nbytes, tag))
        return new_tail

    def allocate_nonpersistent(self, nbytes: int, tag: str = "") -> int:
        """Head stack: function-lifetime. Returns the offset."""
        self._assert_not_frozen()
        off = align_up(self._head, self.alignment)
        self._check_cross(off + int(nbytes), self._tail)
        self._head = off + int(nbytes)
        self.head_allocs.append(Allocation(off, int(nbytes), tag))
        return off

    def reserve_nonpersistent_section(self, nbytes: int, tag: str = "plan") -> int:
        """Reserve the planner-compacted section as one head allocation."""
        return self.allocate_nonpersistent(nbytes, tag)

    # -- temp region (between the stacks; planning-time only) -----------
    def allocate_temp(self, nbytes: int) -> int:
        self._assert_not_frozen()
        off = align_up(self._head + self._temp, self.alignment)
        self._check_cross(self._head, self._tail)
        if off + nbytes > self._tail:
            raise ArenaOverflowError(
                f"temp allocation of {nbytes} bytes does not fit between "
                f"stacks (gap={self._tail - self._head})")
        self._temp = (off + nbytes) - self._head
        self._temp_high_water = max(self._temp_high_water, self._temp)
        return off

    def reset_temp(self) -> None:
        self._temp = 0

    # ------------------------------------------------------------------
    def freeze(self) -> None:
        """End of the init phase: no further allocation of any kind.

        The paper: "we ensure that allocations only occur during the
        interpreter's initialization phase".
        """
        if self._temp:
            raise RuntimeError("temp allocations outstanding at freeze()")
        self._frozen = True

    def _assert_not_frozen(self) -> None:
        if self._frozen:
            raise RuntimeError(
                "allocation after init phase is forbidden (paper §4.4.1)")

    @property
    def frozen(self) -> bool:
        return self._frozen

    # ------------------------------------------------------------------
    @property
    def head_used(self) -> int:
        return self._head

    @property
    def tail_used(self) -> int:
        return self.size - self._tail

    @property
    def free_bytes(self) -> int:
        return self._tail - self._head - self._temp

    def usage(self) -> ArenaUsage:
        return ArenaUsage(
            persistent=self.tail_used,
            nonpersistent=self.head_used,
            temp_high_water=self._temp_high_water,
            total=self.tail_used + self.head_used,
            capacity=self.size,
        )

    # -- multitenancy (§4.5) --------------------------------------------
    def fork_tenant(self) -> "TwoStackArena":
        """A second interpreter allocating from the SAME arena.

        Persistent (tail) allocations stack below the previous tenant's;
        the nonpersistent head section is SHARED — each tenant re-plans it
        from offset 0 and the effective requirement is the max over
        tenants (Figure 5).
        """
        child = TwoStackArena(self.size, self.alignment)
        child._tail = self._tail              # stack under our persistents
        child._head = 0                       # reuse the shared head region
        child._parent = self                  # type: ignore[attr-defined]
        return child

    def absorb_tenant(self, child: "TwoStackArena") -> None:
        """Commit a tenant's allocations back into the shared accounting."""
        self._tail = child._tail
        self.tail_allocs.extend(child.tail_allocs)
        self._head = max(self._head, child._head)
        self.head_allocs.extend(child.head_allocs)
        self._temp_high_water = max(self._temp_high_water,
                                    child._temp_high_water)
