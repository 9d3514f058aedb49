"""Benchmark harness of the port (reference vk_gltf_renderer_tpu/benchmark)."""
