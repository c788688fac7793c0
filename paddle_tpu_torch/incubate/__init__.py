"""Counterpart of ``paddle_tpu.incubate``: the fused functional API that
the eager models reach (:mod:`.nn.functional`)."""
