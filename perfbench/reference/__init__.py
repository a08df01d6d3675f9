"""The plain float32 reference of the benchmark's configurations; it imports nothing of the port."""
