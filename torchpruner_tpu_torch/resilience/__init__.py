"""Resilience helpers of the port — counterpart of
``torchpruner_tpu/resilience/``: the atomic JSON write the checkpoint
and the serving drain snapshot use (:mod:`.manifest`) and the SIGTERM
flag the serving engine polls (:mod:`.guards`).  The run manifests,
chaos injection and the resumable runner are ROADMAP A8."""
