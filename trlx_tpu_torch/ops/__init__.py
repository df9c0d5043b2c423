"""Attention kernels with their plain versions, sampling, prompt batching."""
