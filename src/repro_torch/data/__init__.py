from repro_torch.data.pipeline import SyntheticLM, make_batch_for
