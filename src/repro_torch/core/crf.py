"""Linear-chain CRF — the trellis machinery as a *trainable*
structured-prediction head, in plain PyTorch.

The Viterbi ACS step is a product in the (max,+) semiring; swapping the
semiring to (logsumexp,+) gives the CRF forward algorithm (partition
function), and the gradient of log Z recovers marginals — so one trellis
implementation serves decoding and learning.  Decode reuses
:func:`repro_torch.core.viterbi.hmm_viterbi`; training uses the
forward-backward identity  log p(y|x) = score(x,y) − log Z(x).

The forward pass comes sequential and as a log-depth associative scan over
(logsumexp,+) matrix products — the same tree as the block-parallel (min,+)
decoder (``viterbi._associative_scan``).  There is no kernel here: the
marginals are the autograd gradient of log Z.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.viterbi import _associative_scan, hmm_viterbi


def crf_score(transitions: torch.Tensor, emissions: torch.Tensor,
              tags: torch.Tensor) -> torch.Tensor:
    """Unnormalized path score.  transitions: (S, S) [from, to];
    emissions: (B, T, S); tags: (B, T) integer.  Returns (B,)."""
    tags = tags.long()
    em = torch.gather(emissions, -1, tags[..., None])[..., 0]
    tr = transitions[tags[:, :-1], tags[:, 1:]]
    return em.sum(-1) + tr.sum(-1)


def _lse_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(logsumexp,+) product over the last two axes (batched)."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def crf_log_norm(transitions: torch.Tensor, emissions: torch.Tensor,
                 parallel: bool = False) -> torch.Tensor:
    """log Z via the forward algorithm in the (logsumexp,+) semiring.
    emissions: (B, T, S) -> (B,)."""
    alpha = emissions[:, 0]  # (B, S)
    if not parallel:
        for t in range(1, emissions.shape[1]):
            alpha = torch.logsumexp(alpha[:, :, None] + transitions[None], dim=1) + emissions[:, t]
        return torch.logsumexp(alpha, dim=-1)

    # log-depth: associative scan of the per-step (logsumexp,+) matrices
    mats = transitions[None, None] + emissions[:, 1:, None, :]  # (B, T-1, S, S)
    total = _associative_scan(_lse_matmul, mats, axis=1)[:, -1]  # (B, S, S)
    return torch.logsumexp((alpha[:, :, None] + total).flatten(1), dim=-1)


def crf_loss(transitions, emissions, tags, valid: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Mean negative log-likelihood (full-length sequences)."""
    nll = crf_log_norm(transitions, emissions) - crf_score(transitions, emissions, tags)
    return nll.mean()


def crf_decode(transitions, emissions) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAP tag sequence = Viterbi in the (max,+) semiring with learned
    scores.  Returns (tags (B, T) int32, score (B,))."""
    S = emissions.shape[-1]
    return hmm_viterbi(transitions, emissions,
                       log_init=torch.zeros((S,), device=emissions.device))


def crf_marginals(transitions, emissions) -> torch.Tensor:
    """Posterior tag marginals (B, T, S) via autograd: d logZ / d emissions."""
    with torch.enable_grad():
        em = emissions.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(crf_log_norm(transitions.detach(), em).sum(), em)
    return grad
