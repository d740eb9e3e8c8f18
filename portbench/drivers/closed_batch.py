"""``closed_batch``: ``sequences`` prompts, every one admitted and
prefilled during set-up; the window decodes them, greedy, one token each a
step, and no request ends inside it."""

from __future__ import annotations

from portbench.core import traffic


class Load:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.prompts = traffic.prompts(params["prompt_len"], params["sequences"], seed, vocab)
        self.live = len(self.prompts)  # the most requests live at once
        self.longest = max(len(p) for p in self.prompts)  # the longest prompt

    def setup(self, drv, warm_steps: int, lap) -> None:
        """Every prompt prefilled, then ``warm_steps`` decode steps (the
        graph captures); ``lap(part)`` closes each part of the set-up."""
        for prompt in self.prompts:
            drv.send(prompt)
        lap("prefill")
        for _ in range(warm_steps):
            drv.step()
        lap("warm")

    def step(self, drv) -> float:
        """One step of the window; returns when the host has read its tokens."""
        return drv.step()
