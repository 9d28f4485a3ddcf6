"""Batched LO-RANSAC: every hypothesis of a chunk scored against every point
on the device.

Port of ``pycolmap_tpu/estimators/ransac.py`` (ref: optim/bindings.h:7-27;
upstream optim/ransac.h, optim/loransac.h). Per chunk:

- draw K minimal samples at once (uniform keys from a ``torch.Generator``,
  the m smallest of each row: a sample without replacement);
- run the batched minimal solver -> K x S hypotheses;
- score each against every correspondence (inlier count first, capped
  residual sum as the tie-break, the reference's InlierSupportMeasurer
  order) and keep the best;
- the host adds chunks until COLMAP's confidence rule says stop: one host
  synchronisation per chunk, for the best inlier count and capped sum;
- local optimization: a weighted non-minimal refit on the incumbent's
  inliers, on the device in the first chunk (fused) and on the host's
  order for a later winner.

The data move to the device once, at their own size: the reference pads
rows to 4x steps and caches executables only for its TPU compiles.
Determinism: every estimate seeds its own generator (``seed``, 0 in every
public estimator, as the reference's ``PRNGKey(0)``); the card's and the
CPU's streams differ, and both differ from ``jax.random``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class RANSACOptions(BaseOptions):
    """Defaults match reference RANSACOptions (ref: optim/bindings.h:12-17)."""

    max_error: float = 4.0
    min_inlier_ratio: float = 0.01
    confidence: float = 0.9999
    dyn_num_trials_multiplier: float = 3.0
    min_num_trials: int = 1000
    max_num_trials: int = 100000

    def check(self) -> bool:
        assert self.max_error > 0
        assert 0 <= self.min_inlier_ratio <= 1
        assert 0 < self.confidence <= 1
        assert self.min_num_trials <= self.max_num_trials
        return True


@dataclass
class RANSACReport:
    success: bool
    model: Any = None
    num_trials: int = 0
    support_num_inliers: int = 0
    inlier_mask: Optional[np.ndarray] = None

    @property
    def inlier_ratio(self):
        if self.inlier_mask is None or len(self.inlier_mask) == 0:
            return 0.0
        return self.support_num_inliers / len(self.inlier_mask)


def sample_indices(generator, num_points, sample_size, num_samples):
    """[K, m] distinct indices per row: the m smallest of K x N uniform keys
    drawn from `generator`, on the generator's device."""
    u = torch.rand((num_samples, num_points), generator=generator,
                   device=generator.device)
    return torch.topk(u, sample_size, dim=-1, largest=False).indices


def dyn_num_trials(num_inliers, num_points, sample_size, confidence, multiplier):
    """COLMAP's adaptive trial count (upstream ransac.h ComputeNumTrials)."""
    if num_inliers == 0 or num_points == 0:
        return float("inf")
    ratio = num_inliers / num_points
    nom = 1 - confidence
    denom = 1 - ratio**sample_size
    if denom <= 0:
        return 0
    if nom <= 0 or denom >= 1.0:
        # ratio^m underflowed: effectively zero chance per sample
        return float("inf")
    return math.ceil(math.log(nom) / math.log(denom) * multiplier)


def _tree_map(fn, *trees):
    """fn over a model: one tensor or a tuple of them (absolute pose)."""
    if isinstance(trees[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


class BatchedLORANSAC:
    """Generic batched LO-RANSAC.

    Parameters
    ----------
    minimal_solver:
        (idx [K, m], *data) -> (models with leading [K, S], valid [K, S]).
        Receives the sampled indices and the full data tensors; gathering
        is the solver's job.
    residual_fn:
        (models [K, S], *data) -> squared residuals [K, S, N].
    refit_solver:
        optional (weights [N], *data) -> models [1, S'] + valid for the LO
        step (non-minimal weighted refit).
    sample_size: minimal sample cardinality m.
    chunk_size: hypotheses drawn per chunk.
    """

    def __init__(
        self,
        minimal_solver: Callable,
        residual_fn: Callable,
        sample_size: int,
        refit_solver: Optional[Callable] = None,
        chunk_size: int = 512,
        num_lo_iterations: int = 2,
    ):
        self.minimal_solver = minimal_solver
        self.residual_fn = residual_fn
        self.refit_solver = refit_solver
        self.sample_size = sample_size
        self.chunk_size = chunk_size
        self.num_lo_iterations = num_lo_iterations

    # -- device work -----------------------------------------------------
    def _best(self, models, valid, residuals, max_error_sq):
        """The best hypothesis of [K, S]: max inliers, then min capped
        residual sum; invalid hypotheses (capped = inf) score -inf."""
        num_inliers = torch.sum(residuals <= max_error_sq, dim=-1)
        capped = torch.sum(torch.clamp(residuals, max=max_error_sq), dim=-1)
        num_inliers = torch.where(valid, num_inliers,
                                  torch.zeros_like(num_inliers))
        capped = torch.where(valid, capped, torch.full_like(capped, math.inf))
        order_score = torch.where(
            torch.isfinite(capped),
            num_inliers.to(capped.dtype) - capped / (capped + 1.0),
            torch.full_like(capped, -math.inf),
        )
        # a 1-element index: indexing by a 0-d tensor reads it on the host
        best = torch.argmax(order_score).reshape(1)

        def pick(a):
            """Entry `best` of a [K, S, ...] tensor's K * S hypotheses."""
            return torch.index_select(a.flatten(0, 1), 0, best)[0]

        return (_tree_map(pick, models), pick(num_inliers), pick(capped),
                pick(residuals))

    def run_chunk(self, idx, max_error_sq, *data):
        """Score the hypotheses of the samples idx [K, m]; returns the best
        (model, num_inliers, capped, residuals [N]), all on the device."""
        models, valid = self.minimal_solver(idx, *data)
        residuals = self.residual_fn(models, *data)  # [K, S, N]
        return self._best(models, valid, residuals, max_error_sq)

    def run_refit(self, weights, max_error_sq, *data):
        models, valid = self.refit_solver(weights, *data)
        residuals = self.residual_fn(models, *data)
        return self._best(models, valid, residuals, max_error_sq)

    def run_chunk_lo(self, idx, max_error_sq, *data):
        """A chunk and the whole LO loop with no host synchronisation: the
        weights come from the incumbent's residuals and a refit replaces it
        only if it is better; one that is not leaves it, so the next
        iteration recomputes the same weights and changes nothing."""
        carry = self.run_chunk(idx, max_error_sq, *data)
        for _ in range(self.num_lo_iterations):
            model, num_inl, capped, residuals = carry
            weights = (residuals <= max_error_sq).to(residuals.dtype)
            enough = torch.sum(weights) >= self.sample_size
            r_model, r_inl, r_cap, r_res = self.run_refit(
                weights, max_error_sq, *data)
            better = enough & (
                (r_inl > num_inl) | ((r_inl == num_inl) & (r_cap < capped)))
            carry = (
                _tree_map(lambda a, b: torch.where(better, b, a), model, r_model),
                torch.where(better, r_inl, num_inl),
                torch.where(better, r_cap, capped),
                torch.where(better, r_res, residuals),
            )
        return carry

    # -- host orchestration ------------------------------------------------
    def estimate(self, options: RANSACOptions, *data, device, seed: int = 0
                 ) -> RANSACReport:
        """Run chunks until the confidence criterion is met, then LO-refit.

        data: numpy arrays with one row per correspondence, moved to
        `device` once."""
        n = int(np.asarray(data[0]).shape[0])
        if n < self.sample_size:
            return RANSACReport(success=False)
        data = tuple(torch.as_tensor(np.asarray(d), device=device)
                     for d in data)
        max_error_sq = float(np.float32(options.max_error**2))

        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        best = None  # (num_inliers, capped, model, residuals)
        best_lo_done = False
        trials = 0
        max_trials = min(
            options.max_num_trials,
            # cap implied by min_inlier_ratio (upstream RANSAC constructor)
            dyn_num_trials(
                max(int(options.min_inlier_ratio * n), self.sample_size),
                n,
                self.sample_size,
                options.confidence,
                options.dyn_num_trials_multiplier,
            ),
        )
        first = True
        while trials < max_trials:
            idx = sample_indices(generator, n, self.sample_size,
                                 self.chunk_size)
            # the first chunk runs fused with its LO loop (a confident first
            # chunk then needs nothing more); later chunks run plain, with
            # the host's LO on a later winner
            fused = first and self.refit_solver is not None
            run = self.run_chunk_lo if fused else self.run_chunk
            model, num_inl, capped, residuals = run(idx, max_error_sq, *data)
            # the one host synchronisation of the chunk
            num_inl, capped_f = torch.stack(
                [num_inl.to(capped.dtype), capped]).tolist()
            num_inl = int(num_inl)
            trials += self.chunk_size
            if best is None or (num_inl, -capped_f) > (best[0], -best[1]):
                best = (num_inl, capped_f, model, residuals)
                best_lo_done = fused
            first = False
            if trials >= options.min_num_trials or trials >= max_trials:
                needed = dyn_num_trials(
                    best[0], n, self.sample_size,
                    options.confidence, options.dyn_num_trials_multiplier,
                )
                if trials >= needed:
                    break
        if best is None or best[0] < self.sample_size:
            return RANSACReport(success=False, num_trials=trials)

        num_inl, capped_f, model, residuals = best
        # -- local optimization of a later winner: one synchronisation per
        # refit, for its weight sum, inlier count and capped sum together
        if self.refit_solver is not None and not best_lo_done:
            for _ in range(self.num_lo_iterations):
                weights = (residuals <= max_error_sq).to(residuals.dtype)
                r_model, r_inl, r_capped, r_residuals = self.run_refit(
                    weights, max_error_sq, *data)
                wsum, r_inl, r_capped = torch.stack(
                    [torch.sum(weights), r_inl.to(weights.dtype), r_capped]
                ).tolist()
                if wsum < self.sample_size:
                    break
                if (int(r_inl), -r_capped) > (num_inl, -capped_f):
                    num_inl, capped_f = int(r_inl), r_capped
                    model, residuals = r_model, r_residuals
                else:
                    break

        inlier_mask = (residuals <= max_error_sq).cpu().numpy()
        return RANSACReport(
            success=True,
            model=_tree_map(lambda a: a.cpu().numpy(), model),
            num_trials=trials,
            support_num_inliers=num_inl,
            inlier_mask=inlier_mask,
        )
