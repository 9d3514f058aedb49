"""Device compute of the port (torch) and its numpy host builders.

No module here imports jax. Host builders (flat, bvh_flatten, the host
halves of textures/hdr/hitstate) are numpy copies of the reference's, held
equal to the originals by tests/test_torch_host.py.
"""
