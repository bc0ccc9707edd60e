"""A number that the check compares with the reference, beside its
limit."""
from __future__ import annotations


class Check:
    """The run is correct where every value is at most its limit."""

    def __init__(self, name: str, value: float, limit: float) -> None:
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name} = {self.value!r} (limit "
                f"{self.limit!r}) {'ok' if self.ok else 'FAILED'}")
