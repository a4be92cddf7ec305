"""Execution planes of the port. So far only the durable store's write and
read side (:mod:`.store`), which the provenance ledger writes through."""
