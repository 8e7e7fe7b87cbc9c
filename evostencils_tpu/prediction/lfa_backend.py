"""Evaluation backends for the LFA symbol calculus.

The symbol of a cycle is a DAG of batched complex matrix operations over
frequency samples.  ``ConvergenceEvaluator`` walks the IR once and emits
backend calls; two interchangeable backends execute them:

* :class:`NumpyLfaBackend` — eager batched numpy (T, n, n) arrays, LAPACK
  through numpy.  Reference semantics.
* :class:`NativeLfaBackend` (native/) — records the same calls as a compact
  instruction tape and executes it in the C++ engine
  (native/lfa_engine.cpp): per-frequency sequential execution, OpenMP over
  frequencies, BLAS zgemm / LAPACK zgetri+zgeev.  This is the framework's
  counterpart of the reference's native LFA Lab library
  (reference model_based_prediction/convergence.py:1-22 drives it via
  SWIG + a crash-isolation child process).

Backends deal in opaque handles carrying (rows, cols); the evaluator never
touches the storage, so recording and eager execution share one code path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Handle:
    rows: int
    cols: int
    ref: object   # backend-specific storage / slot id


class NumpyLfaBackend:
    """Eager batched-numpy execution (T, rows, cols) complex128."""

    def __init__(self, thetas: np.ndarray):
        self.thetas = thetas            # (T, d) base frequencies
        self.n_theta = thetas.shape[0]

    # -- leaves --------------------------------------------------------------

    def circulant(self, entries, rel: int, n: int) -> Handle:
        """entries: sequence of (x_idx, y_idx, offset, complex value)."""
        theta = (2 ** rel) * self.thetas
        out = np.zeros((self.n_theta, n, n), dtype=np.complex128)
        for x_idx, y_idx, offset, value in entries:
            phase = np.exp(1j * theta @ np.asarray(offset, float))
            out[:, x_idx, y_idx] += value * phase
        return Handle(n, n, out)

    def selection(self, pairs, rel_fine: int, nc: int, nf: int) -> Handle:
        """Odd-site injection (coarse x fine) with phase e^{i sum theta_f};
        pairs: (c_idx, f_idx)."""
        theta = (2 ** rel_fine) * self.thetas
        phase = np.exp(1j * theta.sum(axis=-1))
        out = np.zeros((self.n_theta, nc, nf), dtype=np.complex128)
        for c_idx, f_idx in pairs:
            out[:, c_idx, f_idx] = phase
        return Handle(nc, nf, out)

    def embedding(self, pairs, rel_fine: int, nc: int, nf: int) -> Handle:
        """Adjoint embedding (fine x coarse) with phase e^{-i sum theta_f}."""
        theta = (2 ** rel_fine) * self.thetas
        phase = np.exp(-1j * theta.sum(axis=-1))
        out = np.zeros((self.n_theta, nf, nc), dtype=np.complex128)
        for c_idx, f_idx in pairs:
            out[:, f_idx, c_idx] = phase
        return Handle(nf, nc, out)

    def diag(self, values: np.ndarray) -> Handle:
        n = len(values)
        m = np.diag(np.asarray(values, dtype=np.complex128))
        return Handle(n, n, np.broadcast_to(m, (self.n_theta, n, n)))

    def identity(self, n: int) -> Handle:
        eye = np.eye(n, dtype=np.complex128)
        return Handle(n, n, np.broadcast_to(eye, (self.n_theta, n, n)))

    def zero(self, rows: int, cols: int) -> Handle:
        return Handle(rows, cols,
                      np.zeros((self.n_theta, rows, cols), np.complex128))

    # -- algebra -------------------------------------------------------------

    def matmul(self, a: Handle, b: Handle) -> Handle:
        return Handle(a.rows, b.cols, a.ref @ b.ref)

    def add(self, a: Handle, b: Handle) -> Handle:
        return Handle(a.rows, a.cols, a.ref + b.ref)

    def sub(self, a: Handle, b: Handle) -> Handle:
        return Handle(a.rows, a.cols, a.ref - b.ref)

    def scale(self, alpha, a: Handle) -> Handle:
        return Handle(a.rows, a.cols, alpha * a.ref)

    def inv(self, a: Handle) -> Handle:
        return Handle(a.rows, a.cols, np.linalg.inv(a.ref))

    def kron_eye(self, nf: int, a: Handle) -> Handle:
        """I_nf (x) A — per-field block diagonal replication."""
        T = self.n_theta
        out = np.zeros((T, nf * a.rows, nf * a.cols), dtype=np.complex128)
        for i in range(nf):
            out[:, i * a.rows:(i + 1) * a.rows,
                i * a.cols:(i + 1) * a.cols] = a.ref
        return Handle(nf * a.rows, nf * a.cols, out)

    def block(self, mf: int, n: int, blocks: Dict[Tuple[int, int], Handle]) \
            -> Handle:
        """(mf x mf) grid of (n x n) blocks; missing blocks are zero."""
        T = self.n_theta
        out = np.zeros((T, mf * n, mf * n), dtype=np.complex128)
        for (i, j), h in blocks.items():
            out[:, i * n:(i + 1) * n, j * n:(j + 1) * n] = h.ref
        return Handle(mf * n, mf * n, out)

    # -- results -------------------------------------------------------------

    def spectral_radius(self, a: Handle) -> float:
        return float(np.abs(np.linalg.eigvals(a.ref)).max())

    def eigenvalues(self, a: Handle) -> np.ndarray:
        return np.linalg.eigvals(a.ref).reshape(-1)
