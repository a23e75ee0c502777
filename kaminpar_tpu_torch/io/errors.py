"""Structured graph-format errors for the IO parsers (counterpart of
kaminpar_tpu/io/errors.py).

A malformed input file (truncated bytes, non-monotone offsets,
out-of-range neighbor ids, overflowing weights) must surface as ONE
exception type that names where in the file the problem is — not as an
IndexError or OverflowError thrown from deep inside numpy, which reads
as a parser bug rather than a data problem.  GraphFormatError subclasses
ValueError so pre-existing callers that caught ValueError keep working.
"""

from __future__ import annotations

from typing import Optional


class GraphFormatError(ValueError):
    """A graph file violates its format.

    Attributes:
      path    file path when known (loaders attach it)
      line    1-based line number for text formats (METIS)
      offset  byte offset for binary formats (ParHiP)
    """

    def __init__(
        self,
        message: str,
        *,
        path: Optional[str] = None,
        line: Optional[int] = None,
        offset: Optional[int] = None,
    ) -> None:
        self.reason = message
        self.path = path
        self.line = line
        self.offset = offset
        super().__init__(self._render())

    def _render(self) -> str:
        where = []
        if self.path is not None:
            where.append(str(self.path))
        if self.line is not None:
            where.append(f"line {self.line}")
        if self.offset is not None:
            where.append(f"byte {self.offset}")
        loc = ", ".join(where)
        return f"{self.reason} ({loc})" if loc else self.reason

    def with_path(self, path: str) -> "GraphFormatError":
        """A copy carrying the file path (loaders call this so parse_*
        stays path-agnostic)."""
        return GraphFormatError(
            self.reason, path=path, line=self.line, offset=self.offset
        )
