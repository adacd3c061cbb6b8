"""HFL system/cost model — paper §III-B, equations (4)–(14), Table I.

Port of ``repro.core.cost_model``, with the availability traces the
async engine runs on (``AvailabilityTrace`` and its samplers). All
quantities SI: seconds, joules, hertz, watts, bits. The wireless network
is simulated: 128.1 + 37.6 log10(d_km) path loss with 8 dB log-normal
shadowing, FDMA uplink (6), and static edge->cloud links (11)-(12).
Population arrays are drawn in float64 with numpy in the reference's
order and cast to float32 tensors, so both packages see the same world.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import dbm_to_watt, resolve_device


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Table I."""
    n_devices: int = 100
    n_edges: int = 5
    area_km: float = 1.0
    u_range: tuple = (1e4, 1e5)            # CPU cycles / sample
    d_range: tuple = (400, 700)            # local dataset sizes D_n
    edge_bw_range: tuple = (0.5e6, 3e6)    # B_m  [Hz]
    cloud_bw: float = 10e6                 # B    [Hz]
    p_dbm_range: tuple = (0.0, 23.0)       # device transmit power
    p_edge_dbm: float = 23.0               # edge transmit power
    f_max: float = 2e9                     # max CPU frequency [Hz]
    noise_dbm_hz: float = -174.0           # N0
    alpha: float = 2e-28                   # effective capacitance (α/2 coeff)
    shadow_db: float = 8.0
    L: int = 5                             # local iterations
    Q: int = 5                             # edge iterations
    lam: float = 1.0                       # λ
    model_bits: float = 448e3 * 8          # z (FashionMNIST CNN default)

    @property
    def n0_w_hz(self) -> float:
        return dbm_to_watt(self.noise_dbm_hz)


@dataclasses.dataclass
class Population:
    """A sampled IoT population: device features + channel gains (f32
    tensors on one device) and the host-side positions."""
    u: torch.Tensor          # (N,) cycles/sample
    D: torch.Tensor          # (N,) samples
    p: torch.Tensor          # (N,) transmit power [W]
    f_max: torch.Tensor      # (N,) [Hz]
    g: torch.Tensor          # (N, M) mean uplink channel gain to each edge
    g_cloud: torch.Tensor    # (M,) edge->cloud gain
    B_m: torch.Tensor        # (M,) edge bandwidth [Hz]
    dev_pos: np.ndarray      # (N, 2) km
    edge_pos: np.ndarray     # (M, 2) km

    @property
    def n_devices(self) -> int:
        return self.g.shape[0]

    @property
    def n_edges(self) -> int:
        return self.g.shape[1]

    def features(self) -> torch.Tensor:
        """(N, M+3) raw per-device feature vectors (ḡ^1..ḡ^M, u, D, p)."""
        return torch.cat([self.g, self.u[:, None], self.D[:, None],
                          self.p[:, None]], dim=1)


@dataclasses.dataclass
class PopulationBatch:
    """E stacked IoT populations: the episode axis of the batched D3QN
    trainer (Alg. 5) and of multi-population assignment searches. Every
    tensor carries a leading population axis; population ``e`` is
    bitwise equal to ``sample_population(sp, seeds[e])`` for the seeds
    it was built from."""
    u: torch.Tensor          # (E, N)
    D: torch.Tensor          # (E, N)
    p: torch.Tensor          # (E, N)
    f_max: torch.Tensor      # (E, N)
    g: torch.Tensor          # (E, N, M)
    g_cloud: torch.Tensor    # (E, M)
    B_m: torch.Tensor        # (E, M)
    dev_pos: np.ndarray      # (E, N, 2) km
    edge_pos: np.ndarray     # (E, M, 2) km

    @property
    def n_pops(self) -> int:
        return self.g.shape[0]

    @property
    def n_devices(self) -> int:
        return self.g.shape[1]

    @property
    def n_edges(self) -> int:
        return self.g.shape[2]

    def pop(self, e: int) -> Population:
        """Population ``e`` as a plain (view-sharing) ``Population``."""
        return Population(u=self.u[e], D=self.D[e], p=self.p[e],
                          f_max=self.f_max[e], g=self.g[e],
                          g_cloud=self.g_cloud[e], B_m=self.B_m[e],
                          dev_pos=self.dev_pos[e], edge_pos=self.edge_pos[e])

    def populations(self) -> list:
        return [self.pop(e) for e in range(self.n_pops)]

    def features(self) -> torch.Tensor:
        """(E, N, M+3) stacked raw per-device feature vectors."""
        return torch.cat([self.g, self.u[..., None], self.D[..., None],
                          self.p[..., None]], dim=-1)

    @classmethod
    def stack(cls, pops) -> "PopulationBatch":
        """Stack same-shape ``Population``s along a new leading axis."""
        pops = list(pops)
        return cls(**{
            f.name: (np.stack if f.name.endswith("_pos") else torch.stack)(
                [getattr(p, f.name) for p in pops])
            for f in dataclasses.fields(cls)})


def _gain(rng: np.random.Generator, dist_km: np.ndarray, shadow_db: float):
    d = np.maximum(dist_km, 0.01)
    pl_db = 128.1 + 37.6 * np.log10(d)
    shadow = rng.normal(0.0, shadow_db, d.shape)
    return 10 ** (-(pl_db + shadow) / 10.0)


def sample_population(sp: SystemParams, seed: int = 0,
                      d_range: Optional[tuple] = None,
                      device="cuda") -> Population:
    """Devices and edges uniform in the square; cloud at the centre.
    ``d_range`` overrides ``sp.d_range`` for the dataset sizes D_n."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    rng = np.random.default_rng(seed)
    N, M = sp.n_devices, sp.n_edges
    dev_pos = rng.uniform(0, sp.area_km, (N, 2))
    edge_pos = rng.uniform(0, sp.area_km, (M, 2))
    cloud_pos = np.array([sp.area_km / 2, sp.area_km / 2])
    d_ne = np.linalg.norm(dev_pos[:, None] - edge_pos[None], axis=-1)
    d_mc = np.linalg.norm(edge_pos - cloud_pos, axis=-1)
    dr = d_range or sp.d_range
    return Population(
        u=f32(rng.uniform(*sp.u_range, N)),
        D=f32(rng.integers(dr[0], dr[1] + 1, N).astype(np.float64)),
        p=f32(dbm_to_watt(rng.uniform(*sp.p_dbm_range, N))),
        f_max=torch.full((N,), sp.f_max, dtype=torch.float32, device=dev),
        g=f32(_gain(rng, d_ne, sp.shadow_db)),
        g_cloud=f32(_gain(rng, d_mc, sp.shadow_db)),
        B_m=f32(rng.uniform(*sp.edge_bw_range, M)),
        dev_pos=dev_pos, edge_pos=edge_pos)


def sample_population_batch(sp: SystemParams, n_pops: Optional[int] = None,
                            seed: int = 0, seeds=None,
                            d_range: Optional[tuple] = None,
                            device="cuda") -> PopulationBatch:
    """E Table-I populations as one stacked ``PopulationBatch``.

    ``seeds`` gives explicit per-population seeds; otherwise ``n_pops``
    seeds are derived from ``seed`` through ``np.random.SeedSequence``,
    as the reference derives them. Population ``e`` is
    ``sample_population(sp, seeds[e], d_range)``.
    """
    if seeds is None:
        if n_pops is None:
            raise ValueError("sample_population_batch needs n_pops or seeds")
        seeds = np.random.SeedSequence(seed).generate_state(n_pops)
    return PopulationBatch.stack(
        sample_population(sp, seed=int(s), d_range=d_range, device=device)
        for s in seeds)


# ------------------------------------------------------- eqs (4)-(8)

def t_cmp(sp: SystemParams, u, D, f):
    """(4): per-edge-iteration computation delay."""
    return sp.L * u * D / f


def e_cmp(sp: SystemParams, u, D, f):
    """(5): per-edge-iteration computation energy."""
    return sp.alpha / 2.0 * sp.L * torch.square(f) * u * D


def uplink_rate(sp: SystemParams, b, g, p):
    """(6): FDMA uplink rate [bit/s].

    Numerics: computed as ((g*p)/N0) / b — never forming N0*b ~ 1e-15,
    whose square underflows f32 in the division's gradient (d(1/y)/dy =
    -1/y^2) and turns every gradient-based consumer's result into NaN.
    """
    b = torch.clamp_min(b, 1.0)
    snr = (g * p / sp.n0_w_hz) / b
    return b * torch.log2(1.0 + snr)


def t_com(sp: SystemParams, b, g, p, model_bits=None):
    """(7)."""
    z = sp.model_bits if model_bits is None else model_bits
    return z / uplink_rate(sp, b, g, p)


def e_com(sp: SystemParams, b, g, p, model_bits=None):
    """(8)."""
    return p * t_com(sp, b, g, p, model_bits)


# ------------------------------------------------------ eqs (9)-(12)

def edge_round_cost(sp: SystemParams, u, D, p, g, b, f, mask,
                    model_bits=None):
    """(9),(10) for one edge: masked devices; returns (T_edge, E_edge)."""
    tc = t_cmp(sp, u, D, f) + t_com(sp, b, g, p, model_bits)
    ec = e_cmp(sp, u, D, f) + e_com(sp, b, g, p, model_bits)
    T_edge = sp.Q * torch.max(torch.where(mask, tc, 0.0))
    E_edge = sp.Q * torch.sum(torch.where(mask, ec, 0.0))
    return T_edge, E_edge


def cloud_cost(sp: SystemParams, g_cloud_m, model_bits=None):
    """(11),(12) for one edge server."""
    z = sp.model_bits if model_bits is None else model_bits
    p_m = dbm_to_watt(sp.p_edge_dbm)
    rate = sp.cloud_bw * torch.log2(1.0 + g_cloud_m * p_m /
                                    (sp.n0_w_hz * sp.cloud_bw))
    T_cloud = z / rate
    return T_cloud, p_m * T_cloud


# ------------------------------------------------------ eqs (13)-(14)

def round_cost_gathered(sp: SystemParams, u, D, p, g_sel, g_cloud, assign,
                        b, f, M: int, model_bits=None):
    """(13)/(14) from pre-gathered cohort tensors.

    u, D, p, g_sel, b, f: (..., H) for the scheduled cohort, with g_sel
    the gain of each device to its *assigned* edge; assign: (..., H)
    int64 edge ids; g_cloud: (..., M). Leading axes are independent
    lanes (the sweep's). Returns (T_i, E_i, T_m, E_m): (...) and
    (..., M).

    Per-edge reductions are scatter-reduces over the assignment ids
    (O(H), no (H, M) one-hot), into zeros, so an edge with no assigned
    devices reduces to 0. On a card the scatter-add is made of atomic
    adds in no fixed order, so the energy sums accumulate in float64 and
    are rounded to f32 once: the result no longer depends on that order.
    """
    tc = t_cmp(sp, u, D, f) + t_com(sp, b, g_sel, p, model_bits)
    ec = e_cmp(sp, u, D, f) + e_com(sp, b, g_sel, p, model_bits)
    zeros = torch.zeros(tc.shape[:-1] + (M,), dtype=torch.float64,
                        device=tc.device)
    T_edge = sp.Q * zeros.to(tc.dtype).scatter_reduce(-1, assign, tc,
                                                      "amax")  # (..., M)
    E_edge = sp.Q * zeros.scatter_add(-1, assign, ec.double()).to(ec.dtype)
    T_cl, E_cl = cloud_cost(sp, g_cloud, model_bits)
    T_m = T_cl + T_edge
    E_m = E_cl + E_edge
    return torch.amax(T_m, -1), torch.sum(E_m, -1), T_m, E_m


def round_cost(sp: SystemParams, pop: Population, sched_idx, assign, b, f,
               model_bits=None):
    """One global iteration's (T_i, E_i, per-edge T_m, per-edge E_m).

    sched_idx: (H,) int64 device indices; assign: (H,) int64 edge index
    per device; b, f: (H,) allocations.
    """
    u, D, p = pop.u[sched_idx], pop.D[sched_idx], pop.p[sched_idx]
    g = pop.g[sched_idx, assign]
    return round_cost_gathered(sp, u, D, p, g, pop.g_cloud, assign, b, f,
                               pop.n_edges, model_bits)


def objective(sp: SystemParams, T_i, E_i):
    """Per-round system cost E_i + λ T_i (problem (17))."""
    return E_i + sp.lam * T_i


def round_msg_bits(sp: SystemParams, n_uplink_msgs, n_cloud_msgs,
                   msg_bits=None) -> float:
    """Bits on the air in one global iteration (Fig. 7f/7g accounting):
    ``n_uplink_msgs`` device→edge updates (Q·H synchronously) plus
    ``n_cloud_msgs`` edge→cloud uploads (M), each ``msg_bits`` bits
    (``sp.model_bits`` by default)."""
    z = sp.model_bits if msg_bits is None else msg_bits
    return float((n_uplink_msgs + n_cloud_msgs) * z)


# ------------------------------------------------- availability traces

@dataclasses.dataclass(frozen=True)
class AvailabilityParams:
    """Intermittent-connectivity knobs for the async engine.

    Devices follow an alternating-renewal (two-state Markov) process:
    exponentially distributed online sessions of mean ``mean_up_s``
    alternate with offline gaps of mean ``mean_down_s``. A
    ``straggler_frac`` fraction of devices has every task latency
    multiplied by ``straggler_scale``; ``jitter_sigma`` adds per-task
    log-normal latency noise (drawn by the engine's host rng, not the
    trace). The defaults are the degenerate always-on, no-straggler
    setting under which the event-driven engine reproduces the
    synchronous round.
    """
    p_offline0: float = 0.0                # fraction initially offline
    mean_up_s: float = float("inf")        # mean online session [s]
    mean_down_s: float = 60.0              # mean offline gap [s]
    straggler_frac: float = 0.0            # fraction of slow devices
    straggler_scale: float = 5.0           # their latency multiplier
    jitter_sigma: float = 0.0              # per-task log-normal sigma


def _draw(given, draw, shape, dtype) -> np.ndarray:
    """``given`` (a caller's draws) as a numpy array of ``shape``, or
    ``draw()`` (a CPU tensor) when it is None."""
    out = np.asarray(draw().numpy() if given is None else given, dtype)
    if out.shape != shape:
        raise ValueError(f"draws of shape {out.shape}, expected {shape}")
    return out


def sample_straggler_scales(generator: torch.Generator,
                            ap: AvailabilityParams, n: int,
                            slow=None) -> np.ndarray:
    """(n,) f32 per-device latency multipliers: ``straggler_scale`` where
    a Bernoulli(``straggler_frac``) draw says slow, else 1. The draw is
    ``uniform < straggler_frac`` on ``generator``; ``slow`` (n,) bool
    injects its outcome instead (e.g. the reference's ``jax.random``
    draw)."""
    slow = _draw(slow, lambda: torch.rand(n, generator=generator)
                 < np.float32(ap.straggler_frac), (n,), bool)
    return np.where(slow, np.float32(ap.straggler_scale), np.float32(1.0))


def _cumsum_blocks16(x: np.ndarray) -> np.ndarray:
    """f32 cumulative sum along the last axis, in the reference's order:
    XLA's CPU reduce-window rewrite sums blocks of 16 sequentially, scans
    the block totals the same way (recursively) and adds each block's
    carry last. A plain sequential f32 sum differs in the last bits from
    the 17th element on."""
    n = x.shape[-1]
    if n <= 16:
        return np.cumsum(x, axis=-1, dtype=np.float32)
    nb = -(-n // 16)
    pad = np.zeros(x.shape[:-1] + (nb * 16 - n,), np.float32)
    blocks = np.concatenate([x, pad], -1).reshape(x.shape[:-1] + (nb, 16))
    inner = np.cumsum(blocks, axis=-1, dtype=np.float32)
    totals = _cumsum_blocks16(inner[..., -1])
    inner[..., 1:, :] += totals[..., :-1, None]
    return inner.reshape(x.shape[:-1] + (nb * 16,))[..., :n]


def sample_toggle_times(generator: torch.Generator, ap: AvailabilityParams,
                        n: int, max_toggles: int = 64, uniforms=None,
                        exponentials=None) -> Tuple[np.ndarray, np.ndarray]:
    """Alternating-renewal availability flips.

    Returns ``(init_up, toggles)``: ``init_up`` (n,) bool initial state
    (``uniform >= p_offline0``), ``toggles`` (n, max_toggles) f32
    ascending flip times. Holding time j is Exp(mean_up) while the
    device is up during period j, Exp(mean_down) while it is down; an
    infinite mean (the always-on default) pushes every later flip to
    +inf, so padding and "never flips" coincide. The (n,) uniforms and
    the (n, max_toggles) unit exponentials are drawn on ``generator`` in
    that order unless given (e.g. the reference's ``jax.random``
    draws); the arithmetic is f32 as the reference's, so its draws give
    its trace bit for bit.
    """
    u = _draw(uniforms, lambda: torch.rand(n, generator=generator), (n,),
              np.float32)
    e = _draw(exponentials, lambda: torch.empty(n, max_toggles).exponential_(
        generator=generator), (n, max_toggles), np.float32)
    init_up = u >= np.float32(ap.p_offline0)
    j = np.arange(max_toggles)[None, :]
    up_during = init_up[:, None] ^ (j % 2 == 1)      # state in period j
    mean = np.where(up_during, np.float32(ap.mean_up_s),
                    np.float32(ap.mean_down_s))
    with np.errstate(invalid="ignore", over="ignore"):
        return init_up, _cumsum_blocks16(e * mean)


@dataclasses.dataclass
class AvailabilityTrace:
    """Host-side per-device availability trace (the async engine's input).

    ``toggles[n]`` holds the ascending virtual times at which device n
    flips between online and offline, +inf padded; ``init_up[n]`` is its
    state at t=0 and ``latency_scale[n]`` multiplies every task latency
    (straggler inflation). Build with :func:`sample_availability`, a
    :class:`repro_torch.core.traffic.TrafficGenerator`, or
    :meth:`always_on` (the degenerate parity trace). The layout is the
    reference's (numpy float64 flips, bool ``init_up``), so a trace
    passes between the packages unchanged.
    """
    init_up: np.ndarray        # (N,) bool state at t=0
    toggles: np.ndarray        # (N, T) ascending flip times [s], inf-pad
    latency_scale: np.ndarray  # (N,) per-device latency multiplier

    @property
    def n_devices(self) -> int:
        return self.init_up.shape[0]

    @classmethod
    def always_on(cls, n: int) -> "AvailabilityTrace":
        """Every device up forever at unit speed (sync parity trace)."""
        return cls(init_up=np.ones(n, bool),
                   toggles=np.full((n, 1), np.inf),
                   latency_scale=np.ones(n))

    def up_at(self, t: float) -> np.ndarray:
        """(N,) bool availability at virtual time ``t``."""
        flips = (self.toggles <= t).sum(axis=1)
        return self.init_up ^ (flips % 2 == 1)

    def toggles_after(self, n: int, t: float) -> np.ndarray:
        """Device n's finite flip times strictly after ``t``, ascending."""
        row = self.toggles[n]
        return row[(row > t) & np.isfinite(row)]


def sample_availability(ap: AvailabilityParams, n: int, seed: int = 0,
                        max_toggles: int = 64, uniforms=None,
                        exponentials=None, slow=None) -> AvailabilityTrace:
    """Sample a host ``AvailabilityTrace``: the toggles, then the
    straggler scales, from one ``torch.Generator`` seeded with ``seed``
    (or from the given draws, as in :func:`sample_toggle_times` and
    :func:`sample_straggler_scales`)."""
    gen = torch.Generator().manual_seed(seed)
    init_up, toggles = sample_toggle_times(gen, ap, n, max_toggles,
                                           uniforms, exponentials)
    scale = sample_straggler_scales(gen, ap, n, slow)
    return AvailabilityTrace(init_up=init_up,
                             toggles=toggles.astype(np.float64),
                             latency_scale=scale.astype(np.float64))
