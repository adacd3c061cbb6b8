"""Algorithm 5 — training the D3QN assignment agent; port of
``repro.drl.train``.

Each episode: a fresh random device population (Table I ranges) of H
scheduled devices; HFEL produces the imitation target Ψ̂; the agent
assigns the H devices one per time-slot with ε-greedy exploration;
rewards are ±1 (eq. 26); minibatches from the replay buffer train the
online network with the double-DQN target (eq. 22); the target network
syncs every J steps.

Two engines share the episode semantics:

* ``engine="serial"`` — one population, one HFEL search, one ε-greedy
  pass and one optimizer step per episode (the oracle);
* ``engine="batched"`` (default) — waves of ``wave_size`` episodes: E
  populations sampled at once, their HFEL targets searched in lockstep
  (``HFELAssigner.assign_batch``), one batched ε-greedy pass
  (``_act_wave``), one ring write, then E TD updates with the every-J
  target sync between them (``_update_wave``). The wave's losses stay on
  the device, unsynchronised, so the updates run while the host starts
  the next wave.

Host-side decisions are numpy with the reference's draw order: per wave,
E population seeds, then ``explore`` (E, H), then ``rand`` (E, H), then
the replay's three draws; HFEL search rngs are ``default_rng(seed ^
0x5EED)``. The agent's features are computed on the host in f32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as cm
from repro_torch.core.assignment.hfel import HFELAssigner
from repro_torch.drl.d3qn import d3qn_init, q_values_all_t
from repro_torch.drl.replay import EpisodeReplay
from repro_torch.optim import adam
from repro_torch.utils import resolve_device, tree_leaves, tree_map

_SEARCH_SEED_XOR = 0x5EED


def minmax_normalize(feats: np.ndarray) -> np.ndarray:
    """eq. (24): min-max over the H scheduled devices (axis -2, so one
    (H, F) episode and a stacked (E, H, F) wave normalise identically)."""
    lo = feats.min(axis=-2, keepdims=True)
    hi = feats.max(axis=-2, keepdims=True)
    return (feats - lo) / np.maximum(hi - lo, 1e-12)


def _agent_features(feats: np.ndarray, M: int) -> np.ndarray:
    """Gains in dB (raw gains span ~6 orders of magnitude and min-max
    normalise to a spike at 0), then eq. (24) min-max; f32 numpy."""
    feats = feats.copy()
    feats[..., :M] = 10.0 * np.log10(np.maximum(feats[..., :M], 1e-30))
    return minmax_normalize(feats)


def drl_features(pop: cm.Population, sched_idx=None) -> np.ndarray:
    """(H, M+3) agent features of a population's scheduled cohort (all
    devices when ``sched_idx`` is None)."""
    feats = pop.features().cpu().numpy()
    if sched_idx is not None:
        feats = feats[np.asarray(sched_idx)]
    return _agent_features(feats, pop.n_edges)


def drl_features_batch(popb: cm.PopulationBatch, sched_idx=None
                       ) -> np.ndarray:
    """(E, H, F) agent features for a whole ``PopulationBatch``.
    sched_idx: shared (H,) indices or per-population (E, H); None keeps
    all devices."""
    feats = popb.features().cpu().numpy()
    if sched_idx is not None:
        sched_idx = np.asarray(sched_idx)
        if sched_idx.ndim == 1:
            feats = feats[:, sched_idx]
        else:
            feats = np.take_along_axis(feats, sched_idx[:, :, None], axis=1)
    return _agent_features(feats, popb.n_edges)


def _training_sp(sp: cm.SystemParams, H: int) -> cm.SystemParams:
    """Table-I params restricted to a cohort of exactly H devices — the
    episode-world shape of both engines."""
    return dataclasses.replace(sp, n_devices=H)


def make_training_population(sp: cm.SystemParams, H: int, seed: int,
                             device="cuda") -> cm.Population:
    """Random population of exactly H scheduled devices (Alg. 5 line 4)."""
    return cm.sample_population(_training_sp(sp, H), seed=seed,
                                device=device)


def make_training_population_batch(sp: cm.SystemParams, H: int, seeds,
                                   device="cuda") -> cm.PopulationBatch:
    """E training worlds stacked; world e is bitwise
    ``make_training_population(sp, H, seeds[e])``."""
    return cm.sample_population_batch(_training_sp(sp, H), seeds=seeds,
                                      device=device)


def _td_loss(params, target_params, feats, ep_idx, slots, actions, rewards,
             gamma: float):
    """Double-DQN TD loss. feats: (n_ep, H, F); tuple indices into those
    episodes. The gradient flows through q(s, a) only: the target (online
    argmax, target network's value, zero at the terminal slot) is
    detached."""
    q_on = q_values_all_t(params, feats)           # (n_ep, H, M)
    H = feats.shape[1]
    q_sa = q_on[ep_idx, slots, actions]
    with torch.no_grad():
        q_tg = q_values_all_t(target_params, feats)
        nxt = torch.clamp_max(slots + 1, H - 1)
        a_star = torch.argmax(q_on[ep_idx, nxt], dim=-1)
        q_next = q_tg[ep_idx, nxt, a_star]
        terminal = slots == H - 1
        y = rewards + gamma * torch.where(terminal, 0.0, q_next)
    return torch.mean(torch.square(y - q_sa))


def _loss_and_grads(params, target_params, mb, gamma: float):
    """(loss, grads) of ``_td_loss`` on one minibatch ``mb`` = (feats,
    ep_idx, slots, actions, rewards); the loss stays on the device."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss = _td_loss(live, target_params, *mb, gamma)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda x: grads[id(x)], live)


def _update_one(params, opt_state, target_params, feats, ep_idx, slots,
                actions, rewards, *, lr: float, gamma: float):
    """One TD minibatch update (the serial engine's optimizer step)."""
    loss, grads = _loss_and_grads(
        params, target_params, (feats, ep_idx, slots, actions, rewards),
        gamma)
    params, opt_state = adam(lr).update(grads, opt_state, params)
    return params, opt_state, loss


def _update_wave(params, opt_state, target_params, step0: int, feats_u,
                 ep_idx_u, slots_u, actions_u, rewards_u, *, lr: float,
                 gamma: float, target_sync: int):
    """U TD updates in a row (U = the minibatches' leading axis), with the
    target network synced to the online one whenever the step count
    reaches a multiple of ``target_sync``. Returns ((params, opt_state,
    target, step), losses (U,)); the losses stay on the device."""
    opt = adam(lr)
    step = int(step0)
    losses = []
    for u in range(feats_u.shape[0]):
        loss, grads = _loss_and_grads(
            params, target_params,
            (feats_u[u], ep_idx_u[u], slots_u[u], actions_u[u],
             rewards_u[u]), gamma)
        params, opt_state = opt.update(grads, opt_state, params)
        step += 1
        if step % target_sync == 0:
            target_params = tree_map(torch.clone, params)
        losses.append(loss)
    return (params, opt_state, target_params, step), torch.stack(losses)


@torch.no_grad()
def _act_wave(params, feats, rand_actions, explore):
    """ε-greedy actions for a whole wave: feats (E, H, F); rand_actions /
    explore (E, H) host-drawn exploration, as tensors on the device."""
    greedy = torch.argmax(q_values_all_t(params, feats), dim=-1)
    return torch.where(explore, rand_actions, greedy)


@dataclasses.dataclass
class D3QNTrainer:
    """Algorithm 5 on ``device`` (``"cuda"`` unless ``"cpu"`` is asked
    for). ``init_params``: initial agent weights (e.g. the reference's,
    through numpy); by default they are drawn from a ``torch.Generator``
    seeded with ``seed``."""
    sp: cm.SystemParams
    H: int = 50
    hidden: int = 256
    gamma: float = 0.99
    lr: float = 1e-3
    minibatch: int = 128           # O
    target_sync: int = 20          # J
    eps_start: float = 0.9
    eps_end: float = 0.05
    eps_decay_episodes: int = 150
    hfel_transfer: int = 100
    hfel_exchange: int = 300
    alloc_steps: int = 120
    seed: int = 0
    engine: str = "batched"        # "batched" | "serial" (the oracle)
    wave_size: int = 8             # E: episodes per batched wave
    device: str = "cuda"
    init_params: Optional[dict] = None

    def __post_init__(self):
        if self.engine not in ("batched", "serial"):
            raise ValueError(
                f"unknown D3QN training engine: {self.engine!r}")
        self.dev = resolve_device(self.device)
        self.feat_dim = self.sp.n_edges + 3
        if self.init_params is not None:
            self.params = params_from_numpy(self.init_params, self.dev)
        else:
            self.params = d3qn_init(
                torch.Generator().manual_seed(self.seed), self.feat_dim,
                self.sp.n_edges, self.hidden, self.dev)
        self.target_params = tree_map(torch.clone, self.params)
        self.opt = adam(self.lr)
        self.opt_state = self.opt.init(self.params)
        self.replay = EpisodeReplay(device=self.dev)
        self.rng = np.random.default_rng(self.seed)
        self.hfel = HFELAssigner(self.sp, self.hfel_transfer,
                                 self.hfel_exchange, self.alloc_steps)
        self.step = 0
        self.episode = 0
        self.reward_history: List[float] = []
        self._update = functools.partial(_update_one, lr=self.lr,
                                         gamma=self.gamma)
        self._update_wave = functools.partial(
            _update_wave, lr=self.lr, gamma=self.gamma,
            target_sync=self.target_sync)

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.dev)

    # ------------------------------------------------------------ acting

    def _epsilon_at(self, episode):
        """Vectorised ε schedule — episode may be an int or an array."""
        t = np.minimum(1.0, np.asarray(episode, np.float64)
                       / self.eps_decay_episodes)
        return self.eps_start + (self.eps_end - self.eps_start) * t

    def epsilon(self) -> float:
        return float(self._epsilon_at(self.episode))

    def act_episode(self, feats_norm: np.ndarray, greedy: bool = False
                    ) -> np.ndarray:
        with torch.no_grad():
            q = q_values_all_t(self.params, self._tensor(feats_norm))
        actions = q.argmax(dim=-1).cpu().numpy()
        if not greedy:
            eps = self.epsilon()
            explore = self.rng.random(len(actions)) < eps
            rand = self.rng.integers(0, self.sp.n_edges, len(actions))
            actions = np.where(explore, rand, actions)
        return actions.astype(np.int64)

    # ---------------------------------------------------------- training

    def run_episode(self) -> Tuple[float, float]:
        """One Alg. 5 episode (serial engine); returns (return, td loss)."""
        pop_seed = int(self.rng.integers(1 << 31))
        pop = make_training_population(self.sp, self.H, seed=pop_seed,
                                       device=self.dev)
        sched = np.arange(self.H)
        # deterministic search seed per population: HFEL's target pattern
        # is then a (learnable) function of the features, not of rng state
        hfel_assign, _ = self.hfel.assign(
            pop, sched, np.random.default_rng(pop_seed ^ _SEARCH_SEED_XOR))
        feats = drl_features(pop)
        actions = self.act_episode(feats)
        rewards = np.where(actions == hfel_assign, 1.0, -1.0)
        self.replay.push(feats, actions, rewards)

        loss = np.nan
        if len(self.replay) > self.minibatch:
            mb = self.replay.sample(self.rng, self.minibatch)
            self.params, self.opt_state, loss_t = self._update(
                self.params, self.opt_state, self.target_params, *mb)
            loss = float(loss_t)
            self.step += 1
            if self.step % self.target_sync == 0:
                self.target_params = tree_map(torch.clone, self.params)
        self.episode += 1
        ret = float(rewards.sum())
        self.reward_history.append(ret)
        return ret, loss

    def run_wave(self, n_episodes=None):
        """One batched wave of E Alg. 5 episodes.

        Returns (per-episode returns (E,), losses): the losses are the
        wave's (E,) device tensor, not synchronised (np.nan before the
        buffer is warm); convert when you read it.
        """
        E = int(self.wave_size if n_episodes is None else n_episodes)
        pop_seeds = [int(self.rng.integers(1 << 31)) for _ in range(E)]
        popb = make_training_population_batch(self.sp, self.H, pop_seeds,
                                              device=self.dev)
        targets, _ = self.hfel.assign_batch(
            popb, np.arange(self.H),
            [np.random.default_rng(s ^ _SEARCH_SEED_XOR)
             for s in pop_seeds])
        feats = drl_features_batch(popb)
        eps = self._epsilon_at(self.episode + np.arange(E))
        explore = self.rng.random((E, self.H)) < eps[:, None]
        rand = self.rng.integers(0, self.sp.n_edges, (E, self.H))
        actions = _act_wave(
            self.params, self._tensor(feats),
            self._tensor(rand, torch.int64),
            self._tensor(explore, torch.bool)).cpu().numpy()
        rewards = np.where(actions == targets, 1.0, -1.0)
        self.replay.push_batch(feats, actions, rewards)
        self.episode += E
        rets = rewards.sum(axis=1)
        self.reward_history.extend(float(r) for r in rets)

        loss = np.nan
        if len(self.replay) > self.minibatch:
            mbs = self.replay.sample_updates(self.rng, E, self.minibatch)
            (self.params, self.opt_state, self.target_params, _), loss = \
                self._update_wave(self.params, self.opt_state,
                                  self.target_params, self.step, *mbs)
            self.step += E
        return rets, loss

    def train(self, max_episodes: int, log_every: int = 25,
              verbose: bool = True) -> List[float]:
        def log(loss):
            avg = float(np.mean(self.reward_history[-50:]))
            print(f"  episode {self.episode:4d}  eps={self.epsilon():.2f}"
                  f"  avg50_return={avg:+.1f}  td_loss={loss:.4f}")

        if self.engine == "serial":
            for _ in range(max_episodes):
                _, loss = self.run_episode()
                if verbose and self.episode % log_every == 0:
                    log(loss)
            return self.reward_history

        done = 0
        while done < max_episodes:
            E = min(self.wave_size, max_episodes - done)
            _, losses = self.run_wave(E)
            done += E
            if verbose and (self.episode // log_every) > \
                    ((self.episode - E) // log_every):
                log(float(torch.as_tensor(losses).float().mean()))
        return self.reward_history
