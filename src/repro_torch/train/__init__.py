"""The train step: loss, gradients (microbatches) and AdamW."""
