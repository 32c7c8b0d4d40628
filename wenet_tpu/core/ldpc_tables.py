"""H2064_516 rate-0.8 repeat-accumulate LDPC code tables, in the dense padded
edge layout the batched decoder consumes.

Code parameters (src/H2064_516_sparse.h:9-15): n=2580, k=2064, m=516,
row weight <=12 (data taps), col weight <=3, repeat-accumulate parity chain.
The RA structure means check i is additionally connected to parity vars
(2064+i-1, 2064+i) — check 0 only to parity var 2064 — exactly the H1/shift=0
wiring of src/mpdecode_core.c:init_c_v_nodes (:211-236).

The decoder never walks a sparse graph: edges are a dense (516, 14) index
tensor + validity mask, so check-side reductions are plain row reduces and
var-side reductions are one gather over `var_edges`.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

N_PARITY = 516          # NUMBERPARITYBITS
N_DATA = 2064           # NUMBERROWSHCOLS (= data bits)
CODE_LEN = 2580         # CODELENGTH
MAX_ROW_W = 12          # data taps per check
MAX_COL_W = 3
MAX_ITER = 10
MAX_CHECK_DEG = MAX_ROW_W + 2   # + two RA parity-chain vars

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@lru_cache(maxsize=1)
def load_raw():
    d = np.load(os.path.join(_DATA_DIR, "h2064_516.npz"))
    return d["H_rows"], d["H_cols"], d["Enc_rows"]


@lru_cache(maxsize=1)
def encoder_taps() -> np.ndarray:
    """(516, 12) 0-based data-bit indices per parity row (tx/ldpc_enc.c:33-48)."""
    _, _, enc = load_raw()
    return (enc - 1).astype(np.int32)


@lru_cache(maxsize=1)
def check_edges():
    """Dense check-side edge table.

    Returns:
      var_idx:  (516, 14) int32 — variable index of each edge (0 where invalid)
      mask:     (516, 14) bool  — edge validity
    Edge slots: up to 12 data taps (only valid where H_rows > 0), then the
    one/two RA parity-chain vars.
    """
    H_rows, _, _ = load_raw()
    var_idx = np.zeros((N_PARITY, MAX_CHECK_DEG), dtype=np.int32)
    mask = np.zeros((N_PARITY, MAX_CHECK_DEG), dtype=bool)
    for i in range(N_PARITY):
        taps = H_rows[i][H_rows[i] > 0] - 1          # 0-based data vars
        deg = len(taps)
        var_idx[i, :deg] = taps
        mask[i, :deg] = True
        if i == 0:
            var_idx[i, deg] = N_DATA + 0
            mask[i, deg] = True
        else:
            var_idx[i, deg] = N_DATA + i - 1
            var_idx[i, deg + 1] = N_DATA + i
            mask[i, deg:deg + 2] = True
    return var_idx, mask


@lru_cache(maxsize=1)
def var_edges():
    """Var-side edge table: for each of the 2580 variables, the flat dense
    slot indices (into the (516*14) check-edge layout) of its incident
    edges, padded to width MAX_COL_W with a dump slot.

    Lets the var->check update be a pure gather (qsum = sum of messages at
    these slots) instead of a scatter-add, which serialises on colliding
    indices.

    Returns:
      slots: (CODE_LEN, MAX_COL_W) int32 indices into the flattened
             (N_PARITY*MAX_CHECK_DEG,) message array; invalid -> dump slot
             (== N_PARITY*MAX_CHECK_DEG, caller pads messages with one 0)
      mask:  (CODE_LEN, MAX_COL_W) bool
    """
    var_idx, cmask = check_edges()
    dump = var_idx.size
    slots = np.full((CODE_LEN, MAX_COL_W), dump, dtype=np.int32)
    mask = np.zeros((CODE_LEN, MAX_COL_W), dtype=bool)
    fill = np.zeros(CODE_LEN, dtype=np.int32)
    flat_pos = np.arange(var_idx.size, dtype=np.int32).reshape(var_idx.shape)
    for i in range(var_idx.shape[0]):
        for j in range(var_idx.shape[1]):
            if cmask[i, j]:
                v = var_idx[i, j]
                slots[v, fill[v]] = flat_pos[i, j]
                mask[v, fill[v]] = True
                fill[v] += 1
    assert fill.max() <= MAX_COL_W
    return slots, mask


def sanity_check():
    var_idx, mask = check_edges()
    degs = mask.sum(axis=1)
    assert degs[0] >= 2 and degs.max() <= MAX_CHECK_DEG
    # every parity var appears exactly twice except the last (once)
    counts = np.bincount(var_idx[mask], minlength=CODE_LEN)
    assert counts[N_DATA:-1].max() == 2 and counts[-1] == 1
    # data var degrees match H_cols occupancy
    _, H_cols, _ = load_raw()
    col_deg = (H_cols > 0).sum(axis=1)
    assert np.array_equal(counts[:N_DATA], col_deg)
    return True
