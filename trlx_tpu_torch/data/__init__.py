"""Config tree and rollout datatypes (counterpart of ``trlx_tpu/data``)."""
