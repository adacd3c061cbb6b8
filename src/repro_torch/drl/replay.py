"""Episode-granular replay buffer Ω with its ring on the device; port of
``repro.drl.replay``.

Tuples (s_t, a_t, r_t, s_{t+1}) of one episode share the feature
sequence, so the buffer stores per-episode (features, actions, rewards)
and samples minibatches as (episode, slot) pairs. Three tensors
(``(capacity, H, F)`` features, ``(capacity, H)`` actions and rewards)
are allocated on the device at the first push and written in place;
only the ring counters live on the host. ``sample_updates`` draws its
indices from the caller's numpy Generator with the reference's three
vectorised calls, so the minibatch stream is the reference's, and
gathers the minibatches on the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import resolve_device


class EpisodeReplay:
    """Device-resident episode ring Ω (see module docstring). The episode
    shape (H, F) is fixed at the first push; a mismatched push raises."""

    def __init__(self, capacity_episodes: int = 2000, device="cuda"):
        self.capacity = capacity_episodes
        self.device = resolve_device(device)
        self._feats: Optional[torch.Tensor] = None     # (cap, H, F)
        self._actions: Optional[torch.Tensor] = None   # (cap, H) int64
        self._rewards: Optional[torch.Tensor] = None   # (cap, H)
        self._n = 0        # episodes currently held (<= capacity)
        self._pos = 0      # next ring write slot

    def _ensure(self, H: int, F: int) -> None:
        if self._feats is None:
            cap, dev = self.capacity, self.device
            self._feats = torch.zeros(cap, H, F, device=dev)
            self._actions = torch.zeros(cap, H, dtype=torch.int64,
                                        device=dev)
            self._rewards = torch.zeros(cap, H, device=dev)
        elif tuple(self._feats.shape[1:]) != (H, F):
            raise ValueError(f"episode shape {(H, F)} != buffer "
                             f"{tuple(self._feats.shape[1:])}")

    @property
    def H(self) -> int:
        return 0 if self._feats is None else self._feats.shape[1]

    def push(self, feats, actions, rewards) -> None:
        """Insert one episode: feats (H, F), actions/rewards (H,)."""
        self.push_batch(np.asarray(feats)[None], np.asarray(actions)[None],
                        np.asarray(rewards)[None])

    def push_batch(self, feats, actions, rewards) -> None:
        """Insert a wave of E episodes: feats (E, H, F), actions/rewards
        (E, H), numpy or tensors. If E exceeds the capacity only the
        most recent ``capacity`` episodes land."""
        dev = self.device
        feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        actions = torch.as_tensor(actions, dtype=torch.int64, device=dev)
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=dev)
        E, H, F = feats.shape
        self._ensure(H, F)
        if E > self.capacity:       # only the tail survives a full lap
            feats = feats[-self.capacity:]
            actions = actions[-self.capacity:]
            rewards = rewards[-self.capacity:]
            self._pos = (self._pos + E) % self.capacity
            E = self.capacity
        slots = torch.as_tensor((self._pos + np.arange(E)) % self.capacity,
                                device=dev)
        self._feats[slots] = feats
        self._actions[slots] = actions
        self._rewards[slots] = rewards
        self._pos = (self._pos + E) % self.capacity
        self._n = min(self._n + E, self.capacity)

    def __len__(self) -> int:
        """Total stored tuples (episodes x slots)."""
        return self._n * self.H

    @property
    def n_episodes(self) -> int:
        return self._n

    def sample(self, rng: np.random.Generator, n_tuples: int,
               max_episodes: int = 8) -> Tuple[torch.Tensor, ...]:
        """One minibatch of ~n_tuples (episode, slot) pairs:
        ``(feats, ep_idx, slots, actions, rewards)`` with feats
        (n_ep, H, F) holding the sampled episodes once each, ep_idx/slots
        (n,) indexing tuples into that stack and actions/rewards (n,)."""
        out = self.sample_updates(rng, 1, n_tuples,
                                  max_episodes=max_episodes)
        return tuple(a[0] for a in out)

    def sample_updates(self, rng: np.random.Generator, n_updates: int,
                       n_tuples: int, max_episodes: int = 8
                       ) -> Tuple[torch.Tensor, ...]:
        """U independent minibatches, stacked: ``(feats, ep_idx, slots,
        actions, rewards)`` with a leading (U,) axis (feats (U, n_ep, H,
        F), the rest (U, n)), on the device. The indices come from three
        vectorised host draws: episodes by argsorted uniforms (without
        replacement within an update), then slots."""
        if self._n == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        U = n_updates
        H = self.H
        n_ep = min(max_episodes, self._n)
        per = max(1, n_tuples // n_ep)
        # (U, n_ep) distinct episode ids per update
        eps = np.argsort(rng.random((U, self._n)), axis=1)[:, :n_ep]
        slots = rng.integers(0, H, (U, n_ep * per))
        ep_idx = np.repeat(np.arange(n_ep)[None], U, axis=0)
        ep_idx = np.repeat(ep_idx, per, axis=1)               # (U, n_ep*per)
        rows = np.take_along_axis(eps, ep_idx, axis=1)        # buffer slots
        eps, rows, slots, ep_idx = (torch.as_tensor(a, device=self.device)
                                    for a in (eps, rows, slots, ep_idx))
        return (self._feats[eps], ep_idx, slots,
                self._actions[rows, slots], self._rewards[rows, slots])
