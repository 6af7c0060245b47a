"""Incubating APIs (counterpart of ``paddle_tpu/incubate``): the
multi-tensor optimizer update."""
