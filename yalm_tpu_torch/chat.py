"""Minimal chat templating for /v1/chat/completions (a copy of
`yalm_tpu/chat.py`, which is pure Python; the port imports nothing of the
JAX package).

The reference has no chat interface at all ("Chat interface has not been
implemented", reference README.md:85). The `.yalm` format carries no chat
template metadata either, so serving uses a small set of built-in templates
selected by name (ChatML default — the most widely adopted convention for
instruct checkpoints of the supported families — plus Mistral/Llama-2
[INST] style), with the stop string handled as plain text since the packed
vocabulary may not contain dedicated special tokens.
"""

from __future__ import annotations

from typing import Sequence

ROLES = ("system", "user", "assistant")


def render_chatml(messages: Sequence[dict]) -> str:
    """<|im_start|>role\\ncontent<|im_end|> ... ending with an open
    assistant turn."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}")
        parts.append(f"<|im_start|>{role}\n{m.get('content', '')}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def render_inst(messages: Sequence[dict]) -> str:
    """Mistral/Llama-2 [INST] convention: system folded into the first user
    turn; assistant turns close each [INST] block."""
    sys_txt = ""
    out = []
    pending_user = None
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if role == "system":
            sys_txt = content
        elif role == "user":
            if pending_user is not None:
                out.append(f"[INST] {pending_user} [/INST]")
            pending_user = (f"{sys_txt}\n\n{content}" if sys_txt else content)
            sys_txt = ""
        elif role == "assistant":
            user = pending_user if pending_user is not None else ""
            out.append(f"[INST] {user} [/INST] {content}")
            pending_user = None
        else:
            raise ValueError(f"unknown role {role!r}")
    out.append(f"[INST] {pending_user if pending_user is not None else ''} [/INST]")
    return "".join(out)


def render_llama3(messages: Sequence[dict]) -> str:
    """Llama-3 instruct convention: <|start_header_id|>role<|end_header_id|>
    blocks separated by <|eot_id|>, ending with an open assistant header."""
    parts = ["<|begin_of_text|>"]
    for m in messages:
        role = m.get("role", "user")
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}")
        parts.append(f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                     f"{m.get('content', '')}<|eot_id|>")
    parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(parts)


def render_gemma(messages: Sequence[dict]) -> str:
    """Gemma instruct convention: <start_of_turn>{user|model}\\n blocks
    closed by <end_of_turn>; system content folds into the first user turn
    (Gemma's template has no system role)."""
    sys_txt = ""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}")
        if role == "system":
            sys_txt = content
            continue
        if role == "user" and sys_txt:
            content = f"{sys_txt}\n\n{content}"
            sys_txt = ""
        name = "model" if role == "assistant" else "user"
        parts.append(f"<start_of_turn>{name}\n{content}<end_of_turn>\n")
    if sys_txt:
        # system content with no user turn after it still conditions the
        # model (as its own user turn; Gemma has no system role)
        parts.append(f"<start_of_turn>user\n{sys_txt}<end_of_turn>\n")
    parts.append("<start_of_turn>model\n")
    return "".join(parts)


TEMPLATES = {
    "chatml": render_chatml,
    "inst": render_inst,
    "llama3": render_llama3,
    "gemma": render_gemma,
}

# text markers that end an assistant turn per template (checked as decoded
# text in addition to the model's own EOS/EOT token ids)
STOP_STRINGS = {
    "chatml": ("<|im_end|>",),
    "inst": ("[INST]",),
    "llama3": ("<|eot_id|>",),
    "gemma": ("<end_of_turn>",),
}


def render(messages: Sequence[dict], template: str = "chatml") -> str:
    if template not in TEMPLATES:
        raise ValueError(f"unknown chat template {template!r}; "
                         f"available: {sorted(TEMPLATES)}")
    return TEMPLATES[template](messages)
