"""Prompt tokens prefilled a second while the engine serves: the prompt
tokens of the window's requests over the seconds their `try_admit` calls
took (the harness's span, ending with the first token on the host;
requests the profiler traced are left out)."""


def read(rec):
    d = rec.data
    seconds = sum(d["service_s"])
    return sum(d["lengths"]) / seconds if seconds > 0 else None
