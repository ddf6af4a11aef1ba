"""Engine: config, paged KV cache, scheduler, forward, sampling and the
async serving loop."""
