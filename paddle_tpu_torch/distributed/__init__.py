"""Distributed pieces of the port (counterpart of
``paddle_tpu/distributed``): so far only the checkpoint format, for one
process. Process groups, collectives and sharded layouts wait for
``ROADMAP.md`` queue A item 6."""
