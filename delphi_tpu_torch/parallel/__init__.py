"""Execution planes of the port. So far the durable store (:mod:`.store`)
and the fault plan's store sites with the shared fingerprint digest
(:mod:`.resilience`)."""
