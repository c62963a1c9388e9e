"""Serving of the port: the batching engine over ``seg_batch_fast`` and the
demo HTTP server."""
