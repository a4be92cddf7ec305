"""Execution planes of the port: the durable store (:mod:`.store`), the
resilience plane (:mod:`.resilience`: the guarded seam, fault plans, the
degradation ladder and phase checkpoints), the launch planner
(:mod:`.planner`), the training pipeline thread (:mod:`.pipeline`) and the
compile plane (:mod:`.compile_plane`: the kernel library's build cache and
prewarm). The JAX package's own ``parallel`` exports are its mesh helpers,
which come with queue 1 item 9 of ``ROADMAP.md``; it exports no name of
these planes at this level, so neither does the port."""
