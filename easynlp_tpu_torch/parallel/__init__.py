"""The port's device-parallel layer (counterpart of easynlp_tpu/parallel):
the process mesh (mesh.py), the collectives (comm.py), parameter sharding
(sharding.py), sequence parallelism in the models (sequence.py) and the
GPipe schedule (pipeline.py)."""
