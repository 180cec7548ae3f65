"""Training over several ranks (counterpart of bert_pytorch_tpu/parallel):
the process group and the collectives (dist), the mesh (mesh), data
parallelism and ZeRO-1 (zero), the coalesced norm reductions (coalesce).
"""
