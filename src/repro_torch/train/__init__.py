"""Training, ported from the JAX package's `repro.train`.

optimizer.py — AdamW with warmup + cosine decay, in place on nested dicts
    of tensors.
train_step.py — the loss, the train step with microbatch accumulation,
    the multi-lane step over stacked job states, and `init_state`.
compression.py — int8 / top-k gradient compression with error feedback
    and the compressed mean over a mesh axis.
"""
