"""Execution planes of the port: the durable store (:mod:`.store`) and the
resilience plane (:mod:`.resilience`: the guarded seam, fault plans, the
degradation ladder and phase checkpoints). The JAX package's own
``parallel`` exports are its mesh helpers, which come with queue 1 item 9
of ``ROADMAP.md``; it exports no resilience name at this level, so neither
does the port."""
