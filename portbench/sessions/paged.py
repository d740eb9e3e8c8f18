"""The program's paged MLA session, ``PagedServingSession``, with the
cell's settings (``page_size``, ``num_splits``, ``prefill_chunk``).  The
pool holds every sequence the traffic keeps live at once at its longest
prompt plus the tokens a run can add (``headroom``), so it never runs
short."""

from __future__ import annotations


class Session:
    def __init__(self, model, params, settings: dict, *, live: int, max_prompt: int,
                 headroom: int):
        from repro_torch.runtime.serve_loop import PagedServingSession

        page = settings["page_size"]
        pages = live * -(-(max_prompt + headroom) // page)
        self.sess = PagedServingSession(
            model, params, num_pages=pages, page_size=page,
            num_splits=settings["num_splits"], prefill_chunk=settings["prefill_chunk"],
        )

    def add(self, prompt) -> int | None:
        return self.sess.add_request(prompt)

    def step(self) -> None:
        self.sess.step()

    def tokens(self, rid: int) -> list[int]:
        return self.sess.outputs[rid]

    def live(self) -> list[int]:
        return list(self.sess.active)

    def counters(self) -> dict:
        return {"graph_captures": self.sess.graph_captures}

    def close(self) -> None:
        self.sess.close()
        self.sess = None
