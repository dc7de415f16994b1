"""Models of the port: the GPT and Llama families' training forward and
loss, their train step, and their cached (serving) forward; the Mellum
family's forward and cached forward (serving only); ResNet."""

from ray_tpu_torch.models import gpt, llama, mellum, resnet  # noqa: F401


def family(model):
    """A model family by name ("gpt", "llama" or "mellum"), or `model`
    itself when it is already a module with the family contract
    (`forward`, `forward_cached`, `lm_head`, `working_params`,
    `CONFIGS`)."""
    if not isinstance(model, str):
        return model
    if model == "gpt":
        return gpt
    if model == "llama":
        return llama
    if model == "mellum":
        return mellum
    raise ValueError(f"unknown model family {model!r} (the port serves "
                     f"'gpt', 'llama' and 'mellum')")
