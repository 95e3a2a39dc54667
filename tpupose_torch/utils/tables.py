"""Minimal ASCII table formatter (PrettyTable replacement).

Counterpart of `tpupose/utils/tables.py`: the reference prints its PCP / AP
score tables with `prettytable` (`src/evalmodel.py:194-205,343-349`); this
renders the same +---+ bordered layout, character for character.
"""
from __future__ import annotations


class Table:
    def __init__(self, field_names):
        self.field_names = [str(f) for f in field_names]
        self.rows: list[list[str]] = []

    def add_row(self, row):
        assert len(row) == len(self.field_names)
        self.rows.append([str(x) for x in row])

    def __str__(self):
        cols = [self.field_names] + self.rows
        widths = [max(len(r[i]) for r in cols) for i in range(len(self.field_names))]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

        def fmt(row):
            return "| " + " | ".join(c.center(w) for c, w in zip(row, widths)) + " |"

        lines = [sep, fmt(self.field_names), sep]
        lines += [fmt(r) for r in self.rows]
        lines.append(sep)
        return "\n".join(lines)
