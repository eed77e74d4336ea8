"""DPG-Bench image generation harness (port of bitdance_tpu/eval/dpg.py; the
reference's eval/eval_dpg.py:11-52).

Four images a prompt, written as one 2x2 grid ``<id>.png`` per prompt id;
the prompts split over the processes. The reference's configuration: cfg
7.5, 50 steps, 1024^2 (scripts/eval/eval_bitdance_14b_64x.sh:10-16). The
external ELLA DPG scorer reads the output directory.

    python -m bitdance_tpu_torch.eval.dpg --model_path models/BitDance-14B-64x
    torchrun --nproc_per_node 8 -m bitdance_tpu_torch.eval.dpg --model_path ...
"""

from __future__ import annotations

import json
import os
import sys

from bitdance_tpu_torch.eval.base import BaseEvaluator, harness_main, save_grid


class DPGEvaluator(BaseEvaluator):
    def build_dataset(self, data_path: str):
        with open(data_path) as f:
            lines = json.load(f)
        datasets = [{"id": pid, "prompt": prompt} for pid, prompt in lines.items()]
        self.datasets = self.shard(datasets)

    def eval(self, data_path: str, save_dir: str, guidance_scale: float = 7.5,
             num_sampling_steps: int = 50, image_size=(1024, 1024),
             max_prompts: int = 0):
        os.makedirs(save_dir, exist_ok=True)
        self.build_dataset(data_path)
        if max_prompts:
            self.datasets = self.datasets[:max_prompts]
        for data in self.datasets:
            images = self.model.generate(
                data["prompt"], height=image_size[0], width=image_size[1],
                num_sampling_steps=num_sampling_steps, guidance_scale=guidance_scale,
                num_images=4, seed=self.seed)
            save_grid(images, os.path.join(save_dir, f"{data['id']}.png"), nrow=2)
        self.logger.info(f"rank {self.rank}: wrote {len(self.datasets)} grids")


def main(argv=None, tokenizer=None) -> int:
    return harness_main(DPGEvaluator, "DPG-Bench generation", "eval_assets/dpg/prompts.json",
                        "results/dpg", 7.5, argv, tokenizer)


if __name__ == "__main__":
    sys.exit(main())
