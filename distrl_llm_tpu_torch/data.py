"""R1-style prompting: the chat-templated prompt column.

Host code copied from the JAX package's ``data.py`` (the port imports nothing
of that package): system+user chat template with ``add_generation_prompt``,
over any tokenizer with a chat template, with a plain ChatML fallback for
template-less test tokenizers. Dataset download/splitting comes with the
trainer (ROADMAP: sync trainer).
"""

from __future__ import annotations

from typing import Mapping, Sequence

# Reference system prompt, verbatim contract.
R1_PREPROMPT = (
    "A conversation between User and Assistant. The user asks a question, and the Assistant solves it.\n"
    "The assistant first thinks about the reasoning process and then provides the user with the answer.\n"
    "The response must follow this format:\n"
    "<think> reasoning process here </think>\n"
    "<answer> answer here </answer>\n"
)

_FALLBACK_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def build_chat_prompt(tokenizer, problem: str, preprompt: str = "", postprompt: str = "") -> str:
    """One problem → chat-templated prompt string (system = preprompt,
    user = problem + ' ' + postprompt, generation prompt appended)."""
    messages = [
        {"role": "system", "content": preprompt},
        {"role": "user", "content": problem + " " + postprompt},
    ]
    kwargs = {}
    # template-less tokenizers get a ChatML-style fallback passed per call
    if getattr(tokenizer, "chat_template", None) is None:
        kwargs["chat_template"] = _FALLBACK_TEMPLATE
    return tokenizer.apply_chat_template(
        messages, add_generation_prompt=True, tokenize=False, **kwargs
    )


def process_dataset(tokenizer, dataset, preprompt: str = "", postprompt: str = ""):
    """Map the ``problem`` column through the chat template. Accepts an HF
    ``datasets.Dataset`` (uses .map) or a plain dict-of-lists (returns a new
    dict)."""

    def _map(examples: Mapping[str, Sequence[str]]) -> dict[str, list[str]]:
        return {
            "problem": [
                build_chat_prompt(tokenizer, p, preprompt, postprompt)
                for p in examples["problem"]
            ]
        }

    if hasattr(dataset, "map"):
        return dataset.map(_map, batched=True)
    out = dict(dataset)
    out.update(_map(dataset))
    return out
