"""Models of the port: the GPT and Llama families' training forward and
loss, their train step, and their cached (serving) forward; ResNet."""

from ray_tpu_torch.models import gpt, llama, resnet  # noqa: F401


def family(model):
    """A model family by name ("gpt" or "llama"), or `model` itself when
    it is already a module with the family contract (`forward`,
    `forward_cached`, `lm_head`, `working_params`, `CONFIGS`)."""
    if not isinstance(model, str):
        return model
    if model == "gpt":
        return gpt
    if model == "llama":
        return llama
    raise ValueError(f"unknown model family {model!r} (the port serves "
                     f"'gpt' and 'llama')")
