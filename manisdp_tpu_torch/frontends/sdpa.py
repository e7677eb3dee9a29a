"""Sparse SDPA (.dat-s) reader -> SeDuMi data.

Equivalent of src/basicfunction/fromsdpa.m (itself from SeDuMi 1.1):
  - entries "<matno> <blkno> <i> <j> <val>"; matno 0 is the objective
    F0; upper-triangle entries are mirrored;
  - the objective is negated (SDPA maximizes what SeDuMi minimizes);
  - negative / size-1 block dims become the nonnegative orthant K.l,
    placed FIRST in the variable order; PSD blocks (dim > 1) follow,
    each stored as a column-major dim^2 vec.
"""

from __future__ import annotations

import re

import numpy as np
import scipy.sparse as sp

from .sedumi import Cone, SedumiData

_STRIP_DIMS = re.compile(r"[\.,(){}]")   # dims line may contain , . ( ) { }
_STRIP_B = re.compile(r"[,(){}]")        # b line keeps decimal points


def read_sdpa(path: str) -> SedumiData:
    with open(path) as f:
        lines = iter(f.readlines())

    def next_data_line():
        for ln in lines:
            s = ln.strip()
            if s and not s.startswith(('"', "*")):
                return s
        raise ValueError("Invalid SDPA file: unexpected end of file")

    m = int(next_data_line().split()[0])
    nblocks = int(next_data_line().split()[0])
    dims = np.array(
        [int(t) for t in _STRIP_DIMS.sub(" ", next_data_line()).split()],
        dtype=np.int64)
    if len(dims) != nblocks or np.any(dims == 0):
        raise ValueError("Invalid SDPA file: bad block dimensions")
    b_line = [float(t)
              for t in _STRIP_B.sub(" ", next_data_line()).split()]
    b = np.asarray(b_line, dtype=np.float64)
    if len(b) != m:
        raise ValueError("Invalid SDPA file: bad right-hand side")

    rows = []
    for ln in lines:
        s = ln.strip()
        if s and not s.startswith(('"', "*")):
            t = s.split()
            rows.append((int(t[0]), int(t[1]), int(t[2]), int(t[3]),
                         float(t[4])))
    E = np.asarray(rows, dtype=np.float64).reshape(-1, 5)

    # variable offsets: LP part (dims <= 1) first, then PSD blocks
    N = int(-dims[dims < 0].sum() + (dims[dims > 1] ** 2).sum()
            + (dims == 1).sum())
    loffset = 0
    sdpoffset = int(np.abs(dims[dims <= 1]).sum())
    offset = np.zeros(nblocks, dtype=np.int64)
    for i in range(nblocks):
        if dims[i] <= 1:
            offset[i] = loffset
            loffset += abs(dims[i])
        else:
            offset[i] = sdpoffset
            sdpoffset += dims[i] ** 2
    stride = np.where(dims < 0, 0, dims)

    matno = E[:, 0].astype(np.int64)
    blk = E[:, 1].astype(np.int64) - 1
    ei = E[:, 2].astype(np.int64)
    ej = E[:, 3].astype(np.int64)
    val = E[:, 4]
    # linear position of (i, j) and its mirror (j, i); diagonal entries
    # mirrored with value zero to avoid double counting
    pos1 = offset[blk] + (ei - 1) * stride[blk] + ej - 1
    pos2 = offset[blk] + (ej - 1) * stride[blk] + ei - 1
    val2 = np.where(ei == ej, 0.0, val)

    is_obj = matno == 0
    c = np.zeros(N)
    np.add.at(c, pos1[is_obj], -val[is_obj])
    np.add.at(c, pos2[is_obj], -val2[is_obj])

    ka = ~is_obj
    At = sp.coo_matrix(
        (np.concatenate([val[ka], val2[ka]]),
         (np.concatenate([pos1[ka], pos2[ka]]),
          np.concatenate([matno[ka] - 1, matno[ka] - 1]))),
        shape=(N, m)).tocsc()

    K = Cone(
        s=[int(d) for d in dims[dims > 1]],
        l=int(-dims[dims < 0].sum() + (dims == 1).sum()))
    return SedumiData(At=At, b=b, c=c, K=K)
