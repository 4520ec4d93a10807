"""Minimal MPS reader/writer (free-format subset).

Covers the constructs needed to load MIPLIB-style instances into a
propagation ``Problem``: ROWS (N/L/G/E), COLUMNS (with INTORG/INTEND
integrality markers), RHS, RANGES, BOUNDS (UP/LO/FX/BV/MI/PL/UI/LI).
The objective row is parsed and ignored (propagation is constraint-only).
Host numpy, on the port's ``core.sparse``: the same text gives the same
``Problem`` arrays, byte for byte, as the JAX package's reader.
"""
from __future__ import annotations

from typing import Dict, List, TextIO

import numpy as np

from ..core.sparse import Problem, csr_from_coo
from ..core.types import INF


def read_mps(f: TextIO) -> Problem:
    section = None
    row_kind: Dict[str, str] = {}
    row_order: List[str] = []
    obj_row = None
    col_ids: Dict[str, int] = {}
    is_int_flags: List[bool] = []
    entries: List[tuple] = []   # (row_name, col_idx, value)
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    bounds: List[tuple] = []    # (kind, col, value)
    integer_mode = False

    for raw in f:
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if not line[0].isspace():  # section header
            section = line.split()[0].upper()
            continue
        tok = line.split()
        if section == "ROWS":
            kind, name = tok[0].upper(), tok[1]
            if kind == "N":
                if obj_row is None:
                    obj_row = name
                continue
            row_kind[name] = kind
            row_order.append(name)
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                marker = tok[2].strip("'").upper()
                integer_mode = marker == "INTORG"
                continue
            col = tok[0]
            if col not in col_ids:
                col_ids[col] = len(col_ids)
                is_int_flags.append(integer_mode)
            j = col_ids[col]
            for r, v in zip(tok[1::2], tok[2::2]):
                if r == obj_row:
                    continue
                entries.append((r, j, float(v)))
        elif section == "RHS":
            for r, v in zip(tok[1::2], tok[2::2]):
                if r != obj_row:
                    rhs[r] = float(v)
        elif section == "RANGES":
            for r, v in zip(tok[1::2], tok[2::2]):
                ranges[r] = float(v)
        elif section == "BOUNDS":
            kind, col = tok[0].upper(), tok[2]
            val = float(tok[3]) if len(tok) > 3 else 0.0
            bounds.append((kind, col, val))

    n = len(col_ids)
    m = len(row_order)
    row_ids = {r: i for i, r in enumerate(row_order)}
    rows = np.array([row_ids[r] for r, _, _ in entries], dtype=np.int32)
    cols = np.array([j for _, j, _ in entries], dtype=np.int32)
    vals = np.array([v for _, _, v in entries], dtype=np.float64)
    csr = csr_from_coo(rows, cols, vals, m, n)

    lhs = np.full(m, -INF)
    rhs_arr = np.full(m, INF)
    for r, i in row_ids.items():
        b = rhs.get(r, 0.0)
        kind = row_kind[r]
        if kind == "L":
            rhs_arr[i] = b
        elif kind == "G":
            lhs[i] = b
        elif kind == "E":
            lhs[i] = rhs_arr[i] = b
        if r in ranges:  # MPS RANGES semantics
            rg = ranges[r]
            if kind == "L":
                lhs[i] = b - abs(rg)
            elif kind == "G":
                rhs_arr[i] = b + abs(rg)
            elif kind == "E":
                if rg >= 0:
                    rhs_arr[i] = b + rg
                else:
                    lhs[i] = b + rg

    lb = np.zeros(n)
    ub = np.full(n, INF)
    is_int = np.array(is_int_flags, dtype=bool)
    ub[is_int] = INF  # integers default [0, inf) unless bounded; BV below
    for kind, col, val in bounds:
        if col not in col_ids:
            continue
        j = col_ids[col]
        if kind == "UP":
            ub[j] = val
            if val < 0 and lb[j] == 0:
                lb[j] = -INF  # MPS quirk
        elif kind == "LO":
            lb[j] = val
        elif kind == "FX":
            lb[j] = ub[j] = val
        elif kind == "BV":
            lb[j], ub[j] = 0.0, 1.0
            is_int[j] = True
        elif kind == "MI":
            lb[j] = -INF
        elif kind == "PL":
            ub[j] = INF
        elif kind == "UI":
            ub[j] = val
            is_int[j] = True
        elif kind == "LI":
            lb[j] = val
            is_int[j] = True

    return Problem(csr=csr, lhs=lhs, rhs=rhs_arr, lb=lb, ub=ub, is_int=is_int)


def write_mps(p: Problem, f: TextIO, name: str = "REPRO"):
    """Write a Problem as free-format MPS (ranged rows via RANGES).

    Values are printed with 17 significant digits, so every finite float64
    survives the write -> read round trip bit-exactly.
    """
    f.write(f"NAME          {name}\n")
    f.write("ROWS\n N  COST\n")
    kinds = []
    for i in range(p.m):
        has_l = p.lhs[i] > -INF
        has_r = p.rhs[i] < INF
        if has_l and has_r:
            kinds.append("E" if p.lhs[i] == p.rhs[i] else "R")
            f.write(f" {'E' if p.lhs[i] == p.rhs[i] else 'L'}  R{i}\n")
        elif has_l:
            kinds.append("G")
            f.write(f" G  R{i}\n")
        else:
            kinds.append("L")
            f.write(f" L  R{i}\n")
    f.write("COLUMNS\n")
    csc_order = {}
    rid = p.csr.row_ids()
    for idx in range(p.csr.nnz):
        csc_order.setdefault(int(p.csr.col[idx]), []).append(
            (int(rid[idx]), float(p.csr.val[idx]))
        )
    int_open = False
    for j in range(p.n):
        if p.is_int[j] and not int_open:
            f.write("    MARKER    'MARKER'  'INTORG'\n")
            int_open = True
        if not p.is_int[j] and int_open:
            f.write("    MARKER    'MARKER'  'INTEND'\n")
            int_open = False
        for i, v in csc_order.get(j, []):
            f.write(f"    C{j}  R{i}  {v:.17g}\n")
    if int_open:
        f.write("    MARKER    'MARKER'  'INTEND'\n")
    f.write("RHS\n")
    for i, kind in enumerate(kinds):
        if kind in ("L", "R"):
            f.write(f"    RHS  R{i}  {p.rhs[i]:.17g}\n")
        elif kind == "G":
            f.write(f"    RHS  R{i}  {p.lhs[i]:.17g}\n")
        elif kind == "E":
            f.write(f"    RHS  R{i}  {p.rhs[i]:.17g}\n")
    f.write("RANGES\n")
    for i, kind in enumerate(kinds):
        if kind == "R":
            f.write(f"    RNG  R{i}  {p.rhs[i] - p.lhs[i]:.17g}\n")
    f.write("BOUNDS\n")
    for j in range(p.n):
        if p.lb[j] <= -INF:
            f.write(f" MI BND  C{j}\n")
        elif p.lb[j] != 0.0:
            f.write(f" LO BND  C{j}  {p.lb[j]:.17g}\n")
        if p.ub[j] < INF:
            f.write(f" UP BND  C{j}  {p.ub[j]:.17g}\n")
    f.write("ENDATA\n")
