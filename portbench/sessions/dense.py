"""The program's dense-cache session, ``ServingSession``: a fixed batch of
``batch`` slots of ``max_len`` rows each (the cell's settings)."""

from __future__ import annotations


class Session:
    def __init__(self, model, params, settings: dict, *, live: int, max_prompt: int,
                 headroom: int):
        from repro_torch.runtime.serve_loop import ServingSession

        batch, max_len = settings["batch"], settings["max_len"]
        if live > batch or max_prompt + headroom > max_len:
            raise ValueError(
                f"{live} live sequences of up to {max_prompt} + {headroom} tokens do not fit "
                f"{batch} slots of {max_len} rows")
        self.sess = ServingSession(model, params, batch_size=batch, max_len=max_len)

    def add(self, prompt) -> int | None:
        return self.sess.add_request(prompt)

    def step(self) -> None:
        self.sess.step()

    def tokens(self, rid: int) -> list[int]:
        return self.sess.outputs[rid]

    def live(self) -> list[int]:
        return [r for r in self.sess.slot_rid if r is not None]

    def counters(self) -> dict:
        return {"graph_captures": self.sess.graph_captures}

    def close(self) -> None:
        self.sess = None
