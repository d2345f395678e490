"""The parallel trainers and renders (counterpart of the JAX parallel/
package) on ``torch.distributed`` process groups: ``comm`` (the groups and
the collectives), ``data_parallel``, ``level_parallel``, ``sample_parallel``,
``multi_scene`` and ``dryrun``."""
