"""PyTorch/CUDA port of ``repro`` (the JAX/Pallas reference package).

``repro_torch`` imports torch and numpy only — never ``jax`` and no module
of ``repro`` — and runs on ``"cuda"`` unless a caller passes
``device="cpu"``. It keeps ``repro``'s layouts (NHWC images, HWIO conv
weights, the same parameter-dict keys), so tensors cross between the two
packages unchanged through numpy (``convert``).

Module map (port -> reference):

=============================================  =================================================
``repro_torch.utils``                          ``repro.utils`` (tree_bytes, tree_flatten_to_vector,
                                               dbm_to_watt, db_to_linear; tree_map,
                                               tree_leaves for nested dicts)
``repro_torch.convert``                        (new) numpy <-> port parameter trees,
                                               flat <-> nested payloads
``repro_torch.data.synthetic``                 ``repro.data.synthetic`` (make_dataset,
                                               make_seq_dataset; numpy copy)
``repro_torch.data.partition``                 ``repro.data.partition`` (numpy copy)
``repro_torch.core.cost_model``                ``repro.core.cost_model`` (eqs. 4-14, PopulationBatch,
                                               availability traces and samplers)
``repro_torch.models.layers``                  ``repro.models.layers`` (he_normal, dense/embed
                                               init, rmsnorm, RoPE, SwiGLU,
                                               causal_conv1d)
``repro_torch.models.mamba2``                  ``repro.models.mamba2`` (SSD chunked and
                                               recurrent, the Mamba-2 block)
``repro_torch.models.moe``                     ``repro.models.moe`` (fixed-capacity top-k
                                               MoE, aux loss)
``repro_torch.models.frontend``                ``repro.models.frontend`` (vlm/audio stubs)
``repro_torch.models.seq_classifier``          ``repro.models.seq_classifier`` (the decoders
                                               as HFL payloads, mini model ξ)
``repro_torch.models.cnn``                     ``repro.models.cnn``
``repro_torch.models.spec``                    ``repro.models.spec`` (cnn_spec, seq_spec)
``repro_torch.configs.base``                   ``repro.configs.base`` (ModelConfig, InputShape)
``repro_torch.configs.<arch>``                 ``repro.configs.<arch>`` for every arch
``repro_torch.configs.registry``               ``repro.configs.registry`` (get_config,
                                               get_smoke_config, variant_for_shape,
                                               get_hfl_spec, HFL_SMOKE_ARCHS)
``repro_torch.models.attention``               ``repro.models.attention`` (GQA, RoPE, SWA,
                                               KV cache; impl "plain"/"kernel")
``repro_torch.models.transformer``             ``repro.models.transformer`` (every family;
                                               forward, loss_fn, decode)
``repro_torch.launch.steps``                   ``repro.launch.steps`` (the train, two-tier,
                                               serve and prefill steps, with or
                                               without a mesh; structs; shard_tree,
                                               full_tree)
``repro_torch.launch.mesh``                    ``repro.launch.mesh`` (production, debug and
                                               sweep DeviceMeshes; init_group)
``repro_torch.parallel.sharding``              ``repro.parallel.sharding`` (PartitionSpec,
                                               the param/act/cache rules, lane
                                               helpers, DTensor placements)
``repro_torch.parallel.sharder``               ``repro.parallel.sharder`` (Sharder,
                                               NoopSharder, MeshSharder, NOOP)
``repro_torch.launch.serve_lm``                ``repro.launch.serve_lm`` (the LM serving CLI)
``repro_torch.core.local_train``               ``repro.core.local_train``
``repro_torch.core.compression``               ``repro.core.compression`` (codecs, error feedback)
``repro_torch.core.hfl``                       ``repro.core.hfl`` (Algorithm 1, with codecs)
``repro_torch.core.resource``                  ``repro.core.resource`` (problem 27, warm starts,
                                               trial layouts)
``repro_torch.core.clustering``                ``repro.core.clustering``
``repro_torch.core.scheduling``                ``repro.core.scheduling`` (device_clustering;
                                               vectorized schedulers, numpy copies;
                                               TracedFedAvg)
``repro_torch.core.assignment.geo``            ``repro.core.assignment.geo`` (GeoAssigner,
                                               geo_assign_traced)
``repro_torch.core.assignment.hfel``           ``repro.core.assignment.hfel`` (host engines:
                                               serial, batched, assign_batch; the device
                                               search hfel_search_traced)
``repro_torch.core.assignment.drl``            ``repro.core.assignment.drl`` (DRLAssigner,
                                               drl_features_traced, drl_assign_traced)
``repro_torch.optim``                          ``repro.optim`` (sgd, adam, adafactor,
                                               clip_by_global_norm, schedules)
``repro_torch.drl``                            ``repro.drl`` (bilstm, d3qn, replay, train:
                                               Algorithm 5)
``repro_torch.core.framework``                 ``repro.core.framework`` (fused and sequential
                                               engines, codecs; geo/hfel/drl assignment;
                                               the lane-batched round body)
``repro_torch.core.sweep``                     ``repro.core.sweep`` (SweepRunner: host loop,
                                               lane batching, lane_chunk, fused engine,
                                               codec carries, ``shard=True`` over the
                                               ranks of a lane mesh)
``repro_torch.core.traffic``                   ``repro.core.traffic`` (TrafficParams,
                                               TrafficGenerator)
``repro_torch.core.async_engine``              ``repro.core.async_engine`` (AsyncConfig,
                                               AsyncHFLEngine: the event loop, codecs,
                                               device and edge residuals)
``repro_torch.checkpoint.ckpt``                ``repro.checkpoint.ckpt`` (save_pytree,
                                               restore_pytree, latest_step; same layout)
``repro_torch.launch.serve``                   ``repro.launch.serve`` (the streaming async-HFL
                                               service CLI: build_world, build_trace,
                                               run_serve)
``repro_torch.kernels.hier_agg.ops``           ``repro.kernels.hier_agg`` masked_aggregate,
                                               weighted_aggregate, masked_decode_aggregate
``repro_torch.kernels.kmeans_dist.ops``        ``repro.kernels.kmeans_dist`` pairwise_sq_dists
``repro_torch.kernels.flash_attention.ops``    ``repro.kernels.flash_attention``
                                               flash_attention (and ``ref.py``)
``repro_torch.kernels.build``                  (new) nvcc build + ctypes loading
``repro_torch.trace``                          (new) phase spans (CUDA-event device time,
                                               no synchronise) and counters of the
                                               round, sweep and set-up paths
=============================================  =================================================

CUDA kernels (``csrc/``, built for ``sm_90a`` at first use) and the
Pallas functions they replace:

* ``csrc/hier_agg.cu`` ->
  ``repro/kernels/hier_agg/hier_agg.py``: ``masked_aggregate_batched_pallas``,
  ``weighted_aggregate_batched_pallas`` and
  ``masked_decode_aggregate_batched_pallas``
* ``csrc/kmeans_dist.cu`` ->
  ``repro/kernels/kmeans_dist/kmeans_dist.py:pairwise_sq_dists_pallas``
* ``csrc/flash_attention.cu`` ->
  ``repro/kernels/flash_attention/flash_attention.py:flash_attention_pallas``

``csrc/hopper.cuh`` holds the Hopper building blocks (mbarriers, TMA
loads, wgmma) that the kernels include.
"""

import importlib

# entry points, imported on first use (``import repro_torch`` stays light)
_EXPORTS = {
    "AsyncConfig": "repro_torch.core.async_engine",
    "AsyncHFLEngine": "repro_torch.core.async_engine",
    "TrafficGenerator": "repro_torch.core.traffic",
    "run_serve": "repro_torch.launch.serve",
    "HFLFramework": "repro_torch.core.framework",
    "FrameworkConfig": "repro_torch.core.framework",
    "SweepRunner": "repro_torch.core.sweep",
    "build_scheduler": "repro_torch.core.sweep",
    "sweep_round": "repro_torch.core.sweep",
    "sweep_scan": "repro_torch.core.sweep",
    "TracedFedAvg": "repro_torch.core.scheduling.schedulers",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
