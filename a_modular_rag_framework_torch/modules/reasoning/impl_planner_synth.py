"""Planner/Synthesizer reasoning agent with self-consistency + REACT refine.

The port's copy of ``a_modular_rag_framework_tpu/modules/reasoning/impl_planner_synth.py``.

Behavior parity with the reference implementation's app/modules/reasoning/
impl_planner_synth.py:14-183:
  PLAN (LLM decomposition, <= max_hops steps) ->
  EVIDENCE (per-step selection with entity hard-filter + channel fusion) ->
  SYNTH (max(n_drafts, sc_runs) drafts, citation-only prompt) ->
  VOTE (normalized majority) ->
  REFINE (coverage < threshold -> neighbor expansion -> re-synthesize).
"""
from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional

from ...core.dto import ReasoningIn, ReasoningOut
from ...core.llm_router import LLMRouter
from ...utils.textspan import capitalized_runs
from ...telemetry.sinks import TelemetrySink, span
from . import strategies

logger = logging.getLogger(__name__)


class ReasoningAgentPlannerSynth:
    def __init__(
        self,
        router: LLMRouter,
        *,
        sink: Optional[TelemetrySink] = None,
        max_hops: int = 3,
        temperature: float = 0.6,
        n_drafts: int = 1,
        sc_runs: int = 3,
        max_refine_rounds: int = 1,
        coverage_threshold: float = 0.2,
        refine_window: int = 2,
        max_expand: int = 5,
    ):
        self.router = router
        self.sink = sink
        self.max_hops = int(max_hops)
        self.temperature = float(temperature)
        self.n_drafts = max(1, int(n_drafts))
        self.sc_runs = max(1, int(sc_runs))
        self.max_refine_rounds = max(0, int(max_refine_rounds))
        self.coverage_threshold = float(coverage_threshold)
        self.refine_window = max(0, int(refine_window))
        self.max_expand = max(0, int(max_expand))

    # ---- stages ----

    def _plan(self, question: str, trace_id: str) -> List[str]:
        prompt = (
            "Break the multi-hop question below into the minimal chain of "
            "single-fact lookups needed to answer it (max "
            f"{self.max_hops} hops). Each hop must name exactly one fact to "
            "find, checkable against a retrieved passage on its own.\n"
            f"Question: {question}\n"
            "Output format: one hop per line, numbered '1) ...', nothing else."
        )
        out = self.router.complete(
            module="ReasoningAgent", purpose="plan", prompt=prompt,
            require={"context_window": 16000, "temperature": 0.2,
                     "trace_id": trace_id},
        )
        steps: List[str] = []
        lines = (strategies.coerce_text(out) or "").splitlines()
        any_numbered = any(re.match(r"^\s*(?:step\s*)?\(?\d+[.):\]-]", ln,
                                    re.I) for ln in lines)
        for line in lines:
            s = line.strip().lstrip("-•*").strip()
            if not s:
                continue
            # strip a leading step marker in its observed LLM variants:
            # "1)", "2.", "3:", "(4)", "5 -", "Step 6:", "step 7 -"
            m = re.match(r"^(?:step\s*)?\(?(\d+)\)?\s*[.):\]-]\s*(.*)$", s,
                         re.I)
            if m:
                s = m.group(2).strip()
            elif any_numbered:
                # some replies open with prose ("Sure! Here is the plan:")
                # before the numbered list — when numbering exists anywhere,
                # unnumbered lines are chatter, not steps
                continue
            if s:
                steps.append(s)
        return steps[: self.max_hops] or [question]

    def _synthesize(self, *, question: str, steps: List[str], citations: str,
                    trace_id: str) -> str:
        guidance = (
            "Answer the question from the numbered citations below and from "
            "nothing else — if the citations don't contain the answer, say "
            "so rather than guessing. Mark every claim you make with the "
            "[#k] tag of the citation that backs it. Keep the answer short."
        )
        plan_block = "\n".join(f"Step {i + 1}: {s}" for i, s in enumerate(steps))
        prompt = (
            f"{guidance}\n\nPlan:\n{plan_block}\n\nCitations:\n{citations}\n"
            f"\nQuestion: {question}\nAnswer:"
        )
        out = self.router.complete(
            module="ReasoningAgent", purpose="synthesize", prompt=prompt,
            require={"context_window": 32000, "temperature": self.temperature,
                     "trace_id": trace_id},
        )
        return strategies.coerce_text(out) or ""

    # ---- main ----

    def reason(self, req: ReasoningIn) -> ReasoningOut:
        trace_id = req.trace_id or "trace-reason"

        with span("Reasoning/Plan", self.sink, trace_id):
            steps = self._plan(req.question, trace_id)

        hits = list(req.hits or [])
        # entity hard-filter from capitalized question tokens
        require_entities = [w for w in (req.question or "").split()
                            if w and w[0].isupper()]
        # full capitalized runs ("Tove Kelanan") for the selector's
        # phrase bonus — token-level matching can't tell the question
        # person from a first-name twin distractor
        entity_phrases = capitalized_runs(req.question or "",
                                          min_words=2, particles=True)

        with span("Reasoning/Evidence", self.sink, trace_id):
            step_evidences, used = strategies.select_evidence_for_steps(
                steps,
                hits,
                per_step_k=2,
                min_score=0.05,
                require_entities=require_entities,
                neighbor_window=self.refine_window,
                neighbor_max_expand=self.max_expand,
                entity_phrases=entity_phrases,
            )
            citations = strategies.build_citation_block(hits, used)

        drafts: List[str] = []
        with span("Reasoning/Synthesize", self.sink, trace_id):
            for _ in range(max(self.n_drafts, self.sc_runs)):
                drafts.append(self._synthesize(
                    question=req.question, steps=steps, citations=citations,
                    trace_id=trace_id,
                ))
        if len(drafts) > 1:
            answer, votes = strategies.majority_vote(drafts)
        else:
            answer, votes = (drafts[0] if drafts else ""), {}

        coverage = len(set(used)) / max(1, len(hits))
        refine_rounds: List[Dict[str, Any]] = []
        if coverage < self.coverage_threshold and self.max_refine_rounds > 0:
            with span("Reasoning/Refine", self.sink, trace_id):
                for r in range(self.max_refine_rounds):
                    new_used = sorted(strategies.expand_with_neighbors(
                        set(used), hits, window=self.refine_window,
                        max_expand=self.max_expand,
                    ))
                    new_citations = strategies.build_citation_block(hits, new_used)
                    new_draft = self._synthesize(
                        question=req.question, steps=steps,
                        citations=new_citations, trace_id=f"{trace_id}-ref{r}",
                    )
                    refine_rounds.append({"round": r, "draft": new_draft})
                    answer, used, citations = new_draft, new_used, new_citations

        return ReasoningOut(
            answer=answer,
            evidence_used=[hits[i] for i in sorted(set(used))
                           if 0 <= i < len(hits)],
            steps=[
                {"plan": "\n".join(steps)},
                {"evidence_map": step_evidences},
                {"citations": citations},
                {"drafts": drafts, "votes": votes},
                {"refine_rounds": refine_rounds},
            ],
            model="planner+synth+react",
        )
