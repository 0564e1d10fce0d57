"""Native (C++) runtime: queues, flags and worker threads, and the async
mapping pipeline built on them."""
