"""The port's object model: so far the host-side KV page allocator."""
