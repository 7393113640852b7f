"""The parallel layer on torch.distributed: meshes of ranks, collectives
over a mesh axis, the four-step coefficient-sharded NTT, the dp/ep/sp/tp
step and the multi-process runtime (the counterpart of
fhe_study_tpu/parallel)."""
