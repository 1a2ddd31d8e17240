"""Multi-frame attention. Counterpart of stable_renderer_tpu/parallel/; ported
so far: ``ring_attention.cross_frame_attention`` (one device). The mesh,
sharding, pipeline and training modules wait for ROADMAP 1.14."""
